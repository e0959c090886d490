"""Shared control-settings constants for the interactive front ends (a
copy of :mod:`glaze_tpu.ui`).

The one table of the ui.rs Controls-window slider ranges (ui.rs:343-358)
that the app's command loop, the browser viewer's server-side clamp and
the viewer page's input bounds read, so that a range cannot drift between
them.
"""

from __future__ import annotations

CONTROL_RANGES = {
    "mouse_sensitivity": (0.01, 10.0),   # "Sensibility" slider
    "mov_speed": (0.01, 100.0),          # "Movement speed (normal)"
    "mov_speed_mul": (1.0, 1000.0),      # "Fast movement multiplier"
    "vert_speed": (0.01, 10.0),          # "Vertical movement speed"
}

CONTROL_FLAGS = ("invert_h", "invert_v", "invert_move")


def clamp(key: str, value) -> float:
    lo, hi = CONTROL_RANGES[key]
    return min(hi, max(lo, float(value)))
