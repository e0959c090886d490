"""The window's milliseconds over the frames presented in it."""


def read(run):
    if not run.intervals:
        return None
    return 1e3 * run.window_s / len(run.intervals)
