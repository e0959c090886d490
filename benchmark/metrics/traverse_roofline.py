"""The traversal kernels' least time (benchmark/roofline.py, over the rays
walked in the sample drawn just before the traced one) as a share of their
device time in the traced sample, %."""


def read(run):
    if run.trace is None or not run.walk_least_ms or not run.trace.walk_s:
        return None
    return 100.0 * run.walk_least_ms / (1e3 * run.trace.walk_s)
