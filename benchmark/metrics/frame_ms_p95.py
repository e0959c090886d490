"""The 95th percentile of every presented-frame interval in the window
(ms), each from one frame's host image being ready to the next's."""

import numpy as np


def read(run):
    if not run.intervals:
        return None
    return float(np.percentile(np.asarray(run.intervals) * 1e3, 95))
