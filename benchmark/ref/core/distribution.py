# Frozen copy of glaze_tpu_torch/core/distribution.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""pbrt-v3 style sampling distributions
(port of lib/src/geometry/distribution.rs), vectorized."""

from __future__ import annotations

import numpy as np


class Distribution1D:
    """A 1D distribution with CDF and integral."""

    def __init__(self, values):
        values = np.asarray(list(values), dtype=np.float32)
        n = len(values)
        cdf = np.zeros(n + 1, dtype=np.float32)
        np.cumsum(values / np.float32(n), out=cdf[1:])
        integral = float(cdf[n])
        if integral == 0.0:
            cdf[1:] = np.arange(1, n + 1, dtype=np.float32) / np.float32(n)
        else:
            cdf[1:] = cdf[1:] / np.float32(integral)
        self._values = values
        self._cdf = cdf
        self._integral = integral

    def cdf(self) -> np.ndarray:
        return self._cdf

    def values(self) -> np.ndarray:
        return self._values

    def integral(self) -> float:
        return self._integral


class Distribution2D:
    """A 2D distribution: conditional rows + a marginal over row integrals."""

    def __init__(self, values, x_size: int):
        vals = np.asarray(list(values), dtype=np.float32).reshape(-1, x_size)
        n_rows, n = vals.shape
        # vectorized equivalent of building one Distribution1D per row
        cdf = np.zeros((n_rows, n + 1), dtype=np.float32)
        np.cumsum(vals / np.float32(n), axis=1, out=cdf[:, 1:])
        integrals = cdf[:, n].copy()
        zero = integrals == 0.0
        uniform = np.arange(1, n + 1, dtype=np.float32) / np.float32(n)
        with np.errstate(divide="ignore", invalid="ignore"):
            normed = cdf[:, 1:] / integrals[:, None]
        cdf[:, 1:] = np.where(zero[:, None], uniform[None, :], normed)
        self._cond_values = vals
        self._cond_cdf = cdf
        self._cond_integrals = integrals
        self._marginal = Distribution1D(integrals)

    def conditional_values(self) -> np.ndarray:
        """(rows, x_size) conditional distribution values."""
        return self._cond_values

    def conditional_cdf(self) -> np.ndarray:
        """(rows, x_size + 1) conditional CDFs."""
        return self._cond_cdf

    def conditional_integrals(self) -> np.ndarray:
        return self._cond_integrals

    def marginal(self) -> Distribution1D:
        return self._marginal

    def dimensions_values(self):
        return (self._cond_values.shape[1], self._cond_values.shape[0])

    def dimensions_cdf(self):
        return (self._cond_cdf.shape[1], self._cond_cdf.shape[0])
