"""Runtime helpers: the program's spans and counters, the profiler trace
and the ``GLAZE_DEBUG`` NaN checks.

The recorder. :func:`span` times a block under a name (:func:`traced`
a function's calls) and :func:`count` adds to a named counter. Both act
only inside ``with recording() as rec:``; outside one, ``span`` returns
the shared no-op :data:`OFF` after one check of a module global and
``count`` returns at once, so neither calls torch, allocates or touches
a device. Inside one, each span adds to its name's count, total and self
time as it ends; while a ``torch.profiler`` runs, it also enters
``torch.profiler.record_function(name)``, so the profiler's Chrome trace
holds it as a ``user_annotation`` on the clock of the device events.
``recording(rows=True)`` also keeps each span's row (name,
``perf_counter_ns`` start and end, parent, thread) and each counter
bump, for a window's summary and for the export; without rows the
recording's memory stays flat however long it runs. Counters are host
ints (shapes, control flow): nothing reads a device value for them.
``rec.summary()`` gives each span's count, total and self seconds and
the counters; ``rec.export(path)`` writes the rows as a Chrome trace.
The CLI records every run without rows (its "Setup time", "Render time"
and "Phases" lines come from spans) and with rows under ``--profile``,
which writes the profiler's trace with the spans. PERF.md lists every
span and counter and what reads it.

``profiler_trace`` is the copy of ``glaze_tpu/utils/runtime.py``'s, on
``torch.profiler`` in place of ``jax.profiler``.
``setup_debug_modes`` reads ``GLAZE_DEBUG`` as the JAX package does; where
that turns on ``jax_debug_nans``, here the renderer checks the path
state's float leaves for NaN after every launch (:func:`check_nans`) and
raises ``FloatingPointError`` naming the launch and the leaf. Off, no
check runs: no sync and no extra kernel. The JAX package's persistent
compilation cache (``enable_compilation_cache``) has no counterpart:
PyTorch runs eagerly and compiles nothing at run time, and the CUDA
kernels are built once into ``build/`` (:mod:`glaze_tpu_torch.cuda_build`).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import threading
import time

TRACE_FILE = "trace.json"

_debug_nans = False


def setup_debug_modes(force: bool | None = None) -> bool:
    """The reference's validation layers (debug.rs:83-165): with
    ``GLAZE_DEBUG`` set to anything but "" or "0" (or ``force=True``) the
    renderer checks its state for NaN after every launch. Returns whether
    enabled. Like the JAX package's, it turns the checks on and never
    off."""
    global _debug_nans
    enabled = (os.environ.get("GLAZE_DEBUG", "") not in ("", "0")
               if force is None else force)
    if enabled:
        _debug_nans = True
    return enabled


def debug_nans() -> bool:
    """True once :func:`setup_debug_modes` has turned the NaN checks on."""
    return _debug_nans


def check_nans(leaves, where: str):
    """Raises FloatingPointError at the first named float tensor of
    ``leaves`` ((name, tensor) pairs) that holds a NaN, naming ``where``
    and the leaf. Infinity passes: ray caps and ``t`` hold it in a correct
    render."""
    import torch

    for name, leaf in leaves:
        if leaf.is_floating_point() and bool(torch.isnan(leaf).any()):
            n = int(torch.isnan(leaf).sum())
            raise FloatingPointError(
                f"GLAZE_DEBUG: NaN in {where}, leaf {name!r} "
                f"({n} of {leaf.numel()} values)")


class profiler_trace:
    """Context manager: records a ``torch.profiler`` trace of the block's
    CPU activity, and its CUDA activity where a card is present, and
    writes it as a Chrome trace (``DIR/trace.json``, readable in
    chrome://tracing or Perfetto) when ``enabled``."""

    def __init__(self, path: str, enabled: bool = True):
        self.path = path
        self.enabled = enabled
        self._prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.path, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(*exc)
            self._prof.export_chrome_trace(os.path.join(self.path, TRACE_FILE))
            self._prof = None
        return False


# -- the recorder ------------------------------------------------------------

# the Recorder of the innermost open recording(), or None: the one check a
# span or a counter makes while nothing records
_rec = None


class _Off:
    """What :func:`span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def span(name: str):
    """A context manager that times its block as the span ``name`` of the
    open recording; :data:`OFF` while none is open."""
    if _rec is None:
        return OFF
    return _Span(_rec, name)


def traced(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1):
    """Adds the host int ``n`` to the counter ``name`` of the open
    recording; nothing while none is open."""
    if _rec is None:
        return
    _rec.count(name, n)


class _Span:
    __slots__ = ("_rec", "_name", "_row", "_rf")

    def __init__(self, rec, name):
        self._rec = rec
        self._name = name

    def __enter__(self):
        rec = self._rec
        tid = threading.get_ident()
        stack = rec._stacks.setdefault(tid, [])
        self._rf = None
        if rec._profiling():
            self._rf = rec._record_function(self._name)
            self._rf.__enter__()
        # [name, start ns, end ns, parent row, thread, ns its child spans
        # cover]: a kept row is appended at the start, so each thread's
        # rows stay in start order
        row = [self._name, time.perf_counter_ns(), None,
               stack[-1] if stack else None, tid, 0]
        stack.append(row)
        if rec.rows:
            rec.spans.append(row)
        self._row = row
        return self

    def __exit__(self, *exc):
        row = self._row
        row[2] = time.perf_counter_ns()
        self._rec._close(row)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def _walk_launches() -> dict:
    """The traversal wrappers' ``.launches`` by name (empty until
    :mod:`glaze_tpu_torch.accel.traverse_cuda` is imported)."""
    tc = sys.modules.get("glaze_tpu_torch.accel.traverse_cuda")
    if tc is None:
        return {}
    return {fn.__name__: fn.launches for fn in tc.KERNEL_WRAPPERS}


class Recorder:
    """The spans and counters of one :func:`recording`: running totals by
    name, and with ``rows`` the rows themselves (``spans``: name, start
    and end ns, parent row, thread, child ns; ``counts``: name, ns, n)."""

    def __init__(self, rows: bool = True):
        import torch

        self.rows = rows
        self.spans = []
        self.counts = []
        self._totals = {}  # name: [count, total ns, self ns]
        self._counters = {}
        self._stacks = {}
        self._profiling = torch.autograd._profiler_enabled
        self._record_function = torch.profiler.record_function
        self.start_ns = time.perf_counter_ns()
        self.end_ns = None
        self._walks = _walk_launches()

    def count(self, name: str, n: int):
        self._counters[name] = self._counters.get(name, 0) + n
        if self.rows:
            self.counts.append((name, time.perf_counter_ns(), n))

    def _close(self, row):
        """Adds the ended span ``row`` to its name's totals: a span inside
        an open span of its own name adds only its self time."""
        self._stacks[row[4]].pop()
        dur = row[2] - row[1]
        up = row[3]
        if up is not None:
            up[5] += dur
        t = self._totals.setdefault(row[0], [0, 0, 0])
        t[2] += dur - row[5]
        while up is not None and up[0] != row[0]:
            up = up[3]
        if up is None:
            t[0] += 1
            t[1] += dur

    def summary(self, start_ns: int | None = None,
                end_ns: int | None = None) -> dict:
        """``{"seconds", "spans": {name: {"count", "total_s", "self_s"}},
        "counters": {name: n}, "walk_launches": {wrapper: n}}`` of the
        spans ended so far. With ``start_ns`` or ``end_ns`` (a recording
        with rows), of the spans that start in [start_ns, end_ns) and have
        ended, and the counter bumps in it; a span inside a span of its own
        name, both in the window, adds only its self time. Self time is the
        span's less what its child spans cover. ``walk_launches`` is how
        far the traversal wrappers' ``.launches`` moved over the whole
        recording so far."""
        now = _walk_launches()
        walks = {k: v - self._walks.get(k, 0) for k, v in now.items()}
        if start_ns is None and end_ns is None:
            hi = self.end_ns or time.perf_counter_ns()
            return {"seconds": (hi - self.start_ns) * 1e-9,
                    "spans": {name: {"count": c, "total_s": t * 1e-9,
                                     "self_s": s * 1e-9}
                              for name, (c, t, s) in self._totals.items()},
                    "counters": dict(self._counters),
                    "walk_launches": walks}
        if not self.rows:
            raise ValueError("a window's summary needs recording(rows=True)")
        lo = self.start_ns if start_ns is None else start_ns
        hi = (self.end_ns or time.perf_counter_ns()) if end_ns is None \
            else end_ns
        rows = [r for r in self.spans
                if r[2] is not None and lo <= r[1] < hi]
        inside = {id(r) for r in rows}
        child = {}
        for r in rows:
            if r[3] is not None:
                child[id(r[3])] = child.get(id(r[3]), 0) + r[2] - r[1]
        spans = {}
        for r in rows:
            s = spans.setdefault(r[0], {"count": 0, "total_s": 0.0,
                                        "self_s": 0.0})
            s["self_s"] += (r[2] - r[1] - child.get(id(r), 0)) * 1e-9
            up = r[3]
            while up is not None and (up[0] != r[0] or id(up) not in inside):
                up = up[3]
            if up is None:
                s["count"] += 1
                s["total_s"] += (r[2] - r[1]) * 1e-9
        counters = {}
        for name, t, n in self.counts:
            if lo <= t < hi:
                counters[name] = counters.get(name, 0) + n
        return {"seconds": (hi - lo) * 1e-9, "spans": spans,
                "counters": counters, "walk_launches": walks}

    def export(self, path: str):
        """Writes the ended spans of a recording with rows as Chrome trace
        events (``ph`` "X", in microseconds of ``perf_counter_ns``, the
        parent's name in ``args``) and each counter's running total
        (``ph`` "C")."""
        pid = os.getpid()
        events = [{"name": r[0], "cat": "program_span", "ph": "X",
                   "ts": r[1] / 1e3, "dur": (r[2] - r[1]) / 1e3, "pid": pid,
                   "tid": r[4],
                   "args": {"parent": None if r[3] is None else r[3][0]}}
                  for r in self.spans if r[2] is not None]
        totals = {}
        for name, t, n in self.counts:
            totals[name] = totals.get(name, 0) + n
            events.append({"name": name, "cat": "program_counter",
                           "ph": "C", "ts": t / 1e3, "pid": pid,
                           "args": {name: totals[name]}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


@contextlib.contextmanager
def recording(rows: bool = True):
    """Records the spans and counters of the block into the
    :class:`Recorder` it yields, keeping their rows if ``rows``. A
    recording opened inside another takes the spans until it closes."""
    global _rec
    rec = Recorder(rows)
    prev, _rec = _rec, rec
    try:
        yield rec
    finally:
        _rec = prev
        rec.end_ns = time.perf_counter_ns()
