"""Seconds from the benchmark's start to its first timed launch."""


def read(run):
    return run.setup_s
