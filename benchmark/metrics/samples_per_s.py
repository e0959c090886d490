"""Pixel samples completed a second over the window, in millions: pixels
x launches completed / launches a sample / the window's seconds."""


def read(run):
    if not run.launches or not run.window_s:
        return None
    return (run.pixels * run.launches / run.launches_per_sample
            / run.window_s / 1e6)
