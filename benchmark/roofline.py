"""The traversal kernels' least time: frozen copies of ``chip_smoke.py``'s
bound arithmetic (``NODE_OPS`` ... ``_bound``) and of the issue rates of
``glaze_tpu_torch/tools/common.py`` (``RATES``, ``ops_clocks``), measured
on the H100 by ``scripts/issue_rates.py``.

The work is counted by walking the rays that the program's traversal
dispatchers received, captured at their entry, with the reference's
frozen plain walkers (:mod:`benchmark.ref.accel.bvh`, ``WalkStats``) over
the tree the reference builds from the scene's triangles. The count
therefore stays what today's classic tree needs, whatever tree or kernels
a later version of the program uses. The least time is the larger of the
bytes over the published HBM rate and the walk's instructions by class at
the issue rates, at the published boost clock on every SM.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM5 data sheet: HBM3 bytes/s, SMs, boost SM clock
PEAK_BYTES = 3.35e12
SMS = 132
SM_HZ = 1.98e9
T_MIN = 1e-4
# the instructions of one walk step by class, as the sm_90a loops issue
# them: a node's slab test; a Moller-Trumbore triangle test; a cell lookup
# of an accepted hit in the masked walks; a fat-leaf column
NODE_OPS = {"FADD": 6, "FMUL": 6, "FMNMX": 10, "FSETP": 3}
TRI_OPS = {"FMUL": 27, "FADD": 19, "FSETP": 7, "FSEL": 3, "MUFU": 1,
           "FFMA": 2}
MASK_OPS = {"FMUL": 2, "FMNMX": 2, "other": 8}
COLUMN_OPS = {"FMUL": 25, "FADD": 17, "FSETP": 6, "MUFU": 1, "FFMA": 2}
BYTES_PER_NODE = 32
BYTES_PER_TRI = 36
BYTES_PER_MASK_WORD = 4
BYTES_PER_COEF_ROW = 76

# thread instructions per SM-clock by class, with the pipe each issues to
ISSUE_PER_SM_CLOCK = 128
RATES = {
    "FADD": ("fma", 128), "FMUL": ("fma", 128), "FFMA": ("fma", 128),
    "FMNMX": ("alu", 64), "FSETP": ("alu", 64), "FSEL": ("alu", 64),
    "LOP3": ("alu", 64), "MUFU": ("sfu", 16),
    "HADD2": ("fma", 128), "HMUL2": ("fma", 128), "HFMA2": ("fma", 128),
    "HSET2": ("alu", 64),
    "HMNMX2": ("alu", 64), "VHMNMX": ("alu", 64), "HSETP2": ("alu", 64),
    "F2FP": ("alu", 64), "LDS64": ("mio", 16),
}

# the program's traversal dispatchers, and the tree fields of a scene
DISPATCHERS = ("closest_hit_soa_auto", "any_hit_soa_auto",
               "closest_hit_soa_masked_auto", "any_hit_soa_masked_auto")
TREES = ("bvh", "bvh_any", "bvh_opaque", "bvh_alpha")


def ops_clocks(counts):
    terms = {"issue": sum(counts.values()) / ISSUE_PER_SM_CLOCK}
    for cls, n in counts.items():
        if cls in RATES:
            pipe, rate = RATES[cls]
            terms[pipe] = terms.get(pipe, 0.0) + n / rate
    return max(terms.values())


def scaled(ops, n):
    return {cls: k * n for cls, k in ops.items()}


def summed(*counts):
    out = {}
    for c in counts:
        for cls, k in c.items():
            out[cls] = out.get(cls, 0) + k
    return out


def ops_ms(counts):
    return ops_clocks(counts) / (SMS * SM_HZ) * 1e3


def _table_bytes(stats):
    return (stats.distinct("nodes") * BYTES_PER_NODE
            + stats.distinct("tris") * BYTES_PER_TRI
            + stats.distinct("mask_words") * BYTES_PER_MASK_WORD
            + stats.distinct("coef") * BYTES_PER_COEF_ROW)


def _bytes_closest(stats, r, cap, masked):
    live = r if cap is None else int((cap > T_MIN).sum())
    ray_in = live * 6 * 4 + (0 if cap is None else r * 4)
    return _table_bytes(stats) + ray_in + r * (16 + int(masked))


def _bytes_anyhit(stats, r, cap, active, t_min, masked):
    n_act = int(active.sum())
    live = int((active & (cap > max(t_min, T_MIN))).sum())
    ray_in = r + n_act * 4 + live * 6 * 4
    return _table_bytes(stats) + ray_in + r * (1 + int(masked))


def walk_ops(stats):
    return summed(scaled(NODE_OPS, stats.node_visits),
                  scaled(TRI_OPS, stats.tri_tests),
                  scaled(MASK_OPS, stats.mask_tests),
                  scaled(COLUMN_OPS, stats.col_tests))


def _bound(nbytes, stats):
    """Least milliseconds: bytes over the HBM rate or the instructions."""
    return max(nbytes / PEAK_BYTES * 1e3, ops_ms(walk_ops(stats)))


class Capture:
    """Records the rays the program's traversal dispatchers receive
    (wrappers installed on the program's ``accel`` module while it is
    entered): the tree's field name in ``scene`` and the rays, cloned."""

    def __init__(self, accel, scene):
        self.accel = accel
        self.fields = {id(getattr(scene, f)): f for f in TREES
                       if getattr(scene, f, None) is not None}
        self.calls = []
        self._orig = {n: getattr(accel, n) for n in DISPATCHERS}
        self._depth = 0

    def __enter__(self):
        def wrap(name):
            orig = self._orig[name]

            def call(bvh, o3, d3, t_max=None, *a, **k):
                if self._depth == 0:
                    self.calls.append(dict(
                        name=name, tree=self.fields.get(id(bvh)),
                        o3=tuple(x.clone() for x in o3),
                        d3=tuple(x.clone() for x in d3),
                        t_max=None if t_max is None else torch.as_tensor(
                            t_max).clone(),
                        t_min=k.get("t_min", a[0] if a else 1e-3),
                        active=(None if k.get("active") is None
                                else k["active"].clone())))
                self._depth += 1
                try:
                    return orig(bvh, o3, d3, t_max, *a, **k)
                finally:
                    self._depth -= 1

            return call

        for n in DISPATCHERS:
            setattr(self.accel, n, wrap(n))
        return self

    def __exit__(self, *exc):
        for n in DISPATCHERS:
            setattr(self.accel, n, self._orig[n])


def least_ms(calls, ref_scene):
    """The summed least time of the captured walks over the reference's
    trees (ms), or None where a call's tree has no counterpart there or is
    a forest."""
    from benchmark.ref.accel import bvh as B

    total = 0.0
    for c in calls:
        tree = getattr(ref_scene, c["tree"] or "", None)
        if tree is None or not isinstance(tree, B.BVH):
            return None
        o = torch.stack(c["o3"], -1)
        d = torch.stack(c["d3"], -1)
        r = o.shape[0]
        masked = c["name"].endswith("masked_auto") and B.has_payload(tree)
        stats = B.WalkStats()
        if c["name"].startswith("closest"):
            walk = B.closest_hit_masked if masked else B.closest_hit
            walk(tree, o, d, c["t_max"], stats=stats)
            cap = (None if c["t_max"] is None
                   else torch.broadcast_to(c["t_max"].to(o.device), (r,)))
            nbytes = _bytes_closest(stats, r, cap, masked)
        else:
            act = (torch.ones(r, dtype=torch.bool, device=o.device)
                   if c["active"] is None else c["active"])
            cap = torch.broadcast_to(c["t_max"].to(o.device), (r,))
            walk = B.any_hit_masked if masked else B.any_hit
            walk(tree, o, d, cap, t_min=c["t_min"], active=act, stats=stats)
            nbytes = _bytes_anyhit(stats, r, cap, act, c["t_min"], masked)
        total += _bound(nbytes, stats)
    return total
