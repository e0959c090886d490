"""CUDA kernels launched a presented frame in the traced segment."""


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    return run.trace.kernels / run.traced_frames
