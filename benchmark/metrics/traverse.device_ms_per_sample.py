"""Device milliseconds of the traversal kernels a sample in the traced
segment."""


def read(run):
    if run.trace is None or not run.traced_samples or not run.trace.walk_s:
        return None
    return 1e3 * run.trace.walk_s / run.traced_samples
