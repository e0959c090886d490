"""CUDA kernels launched a pixel sample in the traced segment."""


def read(run):
    if run.trace is None or not run.traced_samples:
        return None
    return run.trace.kernels / run.traced_samples
