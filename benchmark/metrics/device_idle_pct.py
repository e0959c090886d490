"""The device's idle share of the traced segment, %: 1 - the union of its
operations' intervals over the segment, averaged over the cards."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
