"""Structured logging with env-controlled levels.

The reference routes everything through the Rust ``log`` crate with
``env_logger`` (``RUST_LOG=warn|info|debug``, initialized in all three
binaries). Equivalent here: ``GLAZE_LOG=error|warn|info|debug`` controls
a package-wide ``logging`` hierarchy; ``init()`` is called by the three
entry points and is an importable no-op for library users who configure
logging themselves.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
}

_initialized = False


def init(default: str = "warn") -> None:
    """Configures the ``glaze_tpu_torch`` logger from ``GLAZE_LOG``
    (idempotent, the env_logger::init of cli/src/main.rs:43 etc.)."""
    global _initialized
    if _initialized:
        return
    level = _LEVELS.get(os.environ.get("GLAZE_LOG", default).lower(),
                        logging.WARNING)
    root = logging.getLogger("glaze_tpu_torch")
    root.setLevel(level)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(levelname).1s %(name)s] %(message)s")
        )
        root.addHandler(handler)
    root.propagate = False
    _initialized = True


def get_logger(name: str) -> logging.Logger:
    """Namespaced logger, e.g. ``get_logger("converter")``."""
    return logging.getLogger(f"glaze_tpu_torch.{name}")
