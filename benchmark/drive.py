"""One run of a cell: set-up, the measured window, the check.

The program (``glaze_tpu_torch``) is driven through its own entry points:
``RayTraceRenderer.draw`` for ``offline`` traffic (optionally over a
``mesh``), ``RealtimeRenderer.draw_frame(pipelined=True)`` for
``interactive`` traffic. Both loops are closed: the next call goes out
when the last returns. After the window the program's outputs are handed
to :mod:`benchmark.reference`, which decides ``correct``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import tempfile
import time

import torch

from benchmark import cells, reference, schedule
from benchmark.cells import HERE

SCENE_DIR = os.path.join(HERE, "cache", "scenes")
# switches the program reads from the environment that change a result or
# a path: the configuration file states every choice instead
PROGRAM_SWITCHES = ("GLAZE_TREE", "GLAZE_FATLEAF", "GLAZE_COHERENT",
                    "GLAZE_ALPHA_ROUNDS", "GLAZE_ALPHA_MASK", "GLAZE_TILE",
                    "GLAZE_SIF", "GLAZE_SAMPLER", "GLAZE_ADAPTIVE",
                    "GLAZE_ADAPTIVE_TAU", "GLAZE_ADAPTIVE_MIN", "GLAZE_DEBUG")


class _Closed(Exception):
    """Raised from the progress callback once the window has closed."""


class Run:
    """What a run measured, for the metric readers (``metrics/*.py``):
    ``setup_s``, ``spans`` (seconds by name), ``window_s``, and by
    traffic ``launches`` / ``pixels`` / ``launches_per_sample`` (offline)
    or ``intervals`` (interactive, seconds between presented frames);
    with ``--trace 1`` also ``trace`` (:class:`benchmark.trace.TraceData`),
    ``traced_samples`` / ``traced_frames`` and ``walk_least_ms``."""

    def __init__(self, cell, seed, seconds, trace):
        self.cell, self.seed, self.seconds, self.trace_on = (
            cell, seed, seconds, trace)
        self.setup_s = None
        self.spans = {}
        self.window_s = None
        self.launches = 0
        self.pixels = 0
        self.launches_per_sample = 6
        self.intervals = []
        self.trace = None
        self.traced_samples = 0
        self.traced_frames = 0
        self.walk_least_ms = None
        self.capture = None
        self.attempted = 0
        self.check_s = None


def scene_file(config: dict) -> str:
    """The configuration's ``.glaze``, written by the frozen generator on
    the first run in a checkout."""
    from benchmark.ref import scenes

    path = os.path.join(SCENE_DIR, f"{config['scene']}.glaze")
    if not os.path.exists(path):
        os.makedirs(SCENE_DIR, exist_ok=True)
        gen = {"sponza": scenes.SponzaScene,
               "matrow": scenes.MatRowScene}[config["scene"]]
        # written aside and renamed: concurrent writers never see half a file
        fd, tmp = tempfile.mkstemp(suffix=".part", dir=SCENE_DIR)
        os.close(fd)
        try:
            scenes.write_glaze(gen(), tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


def limits(cell) -> dict:
    """The check's limits: ``limits/<cell>.json``, else
    ``limits/default.json``."""
    path = os.path.join(cell.home, "limits", f"{cell.name}.json")
    if not os.path.exists(path):
        path = os.path.join(cell.home, "limits", "default.json")
    with open(path) as f:
        return json.load(f)


def prepare_environment(cell):
    """The program's switches cleared but for those that the configuration
    states (the tree, the sampler, the alpha rounds where a material has
    an opacity map), its BVH cache kept inside the checkout."""
    for k in PROGRAM_SWITCHES:
        os.environ.pop(k, None)
    cfg = cell.config
    os.environ["GLAZE_TREE"] = cfg["tree"]
    os.environ["GLAZE_SAMPLER"] = cfg["sampler"]
    os.environ["GLAZE_ALPHA_ROUNDS"] = str(int(cfg["alpha_rounds"]))
    os.environ["GLAZE_CACHE_DIR"] = os.path.join(HERE, "cache")


def _held_to(cell, coherent, sampler=None):
    """Raises where the renderer resolved another coherent mode or
    sampler than the cell states."""
    want = {"off": 0, "frame": 1, "tile": 2}[cell.traffic["coherent"]]
    if coherent != want or sampler not in (None, cell.config["sampler"]):
        raise RuntimeError(
            f"{cell.name}: the renderer runs coherent {coherent}, sampler "
            f"{sampler}; the cell states {cell.traffic['coherent']}, "
            f"{cell.config['sampler']}")


def devices_of(cell, device):
    """The cards a run uses: every visible one under a mesh, else
    ``device`` with its index."""
    if cell.config.get("mesh") and torch.device(device).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [_indexed(device)]


def program_state(renderer):
    """The progressive state of a ``RayTraceRenderer``. The program has no
    public accessor for it; the check gathers its sampled lanes right
    away, so it never holds a tensor that the program may update in
    place."""
    return renderer._state


@contextlib.contextmanager
def flatten_span(run: Run):
    """Times the program's ``flatten_scene_np`` (host flatten, opacity
    split, BVH build or cache load) as the span ``setup.flatten_s``."""
    from glaze_tpu_torch.scene import flatten as fl

    orig = fl.flatten_scene_np

    def timed(parsed):
        t = time.perf_counter()
        try:
            return orig(parsed)
        finally:
            run.spans["setup.flatten_s"] = (run.spans.get("setup.flatten_s",
                                                          0.0)
                                            + time.perf_counter() - t)

    fl.flatten_scene_np = timed
    try:
        yield
    finally:
        fl.flatten_scene_np = orig


def _indexed(d):
    """``d`` with its index (``cuda`` names the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _peak(devices):
    cuda = [d for d in devices if d.type == "cuda"]
    return max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)


def offline(cell, run: Run, device, t_start):
    """Draws as the CLI does, ``spp_per_draw`` samples a call in chunks of
    launches, each chunk's end a synchronised callback; the window closes
    at the first callback past the deadline. Returns what the check
    needs."""
    from glaze_tpu_torch import accel
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render.renderer import Integrator, RayTraceRenderer

    cfg, tr = cell.config, cell.traffic
    w, h = int(cfg["width"]), int(cfg["height"])
    parsed = parse(scene_file(cfg))
    with flatten_span(run):
        r = RayTraceRenderer(parsed, width=w, height=h,
                             integrator=Integrator(cfg["integrator"]),
                             seed=run.seed, device=device,
                             coherent=tr["coherent"], sampler=cfg["sampler"],
                             mesh=cfg.get("mesh"))
    _held_to(cell, r.coherent, r.sampler)
    devices = devices_of(cell, r.device)
    run.launches_per_sample = r.integrator.steps_per_sample
    run.pixels = w * h
    lanes = reference.sample_lanes(w, h, run.seed)
    idx = torch.from_numpy(lanes).to(r.device)
    draws = []
    warm = int(tr["warmup_spp"])
    r.draw(warm, return_image=False)
    draws.append((warm, r.launches(warm)))
    _sync(devices)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    if run.trace_on:
        from benchmark import roofline
        from benchmark.trace import Segment

        n = int(tr["trace_spp"])
        if not cfg.get("mesh"):
            # the walks' rays, captured in a sample of their own outside
            # the traced one, so the copies stay out of the trace (a mesh's
            # slots walk copies of the trees the reference has none of)
            cap = roofline.Capture(accel, r.scene)
            with cap:
                r.draw(n, return_image=False)
            draws.append((n, r.launches(n)))
            run.capture = cap.calls
        with Segment(cell.name, [d.index for d in devices]) as seg:
            r.draw(n, return_image=False)
        draws.append((n, r.launches(n)))
        run.trace, run.traced_samples = seg.data, n
        t0 = time.perf_counter()
    before_window = sum(n for _, n in draws)
    deadline = t0 + run.seconds
    marks = []
    spp = int(tr["spp_per_draw"])
    base = before_window
    # the sampled lanes of the state before the window, after its first
    # chunk, and after the last two chunks, gathered at each synchronised
    # callback (a copy a few kernels long)
    snaps = [(base, _lanes_of(program_state(r), idx))]
    closed = False
    while not closed:
        ran = [0]

        def progress(done):
            now = time.perf_counter()
            ran[0] = done
            marks.append((now, base + done))
            snaps.append((base + done, _lanes_of(program_state(r), idx)))
            if len(snaps) > 4:
                del snaps[2]
            if now >= deadline:
                raise _Closed

        try:
            r.draw(spp, progress, return_image=False)
        except _Closed:
            closed = True
        draws.append((spp, ran[0]))
        base += ran[0]
    inside = [m for m in marks if m[0] <= deadline] or marks[:1]
    t_end, launched = inside[-1]
    run.window_s = t_end - t0
    run.launches = launched - before_window
    run.attempted = run.launches
    peak = _peak(devices)
    (l_first, first), (l_before, before), (l_end, end) = (
        snaps[1], snaps[-2], snaps[-1])
    del r, snaps
    return dict(draws=draws, lanes=lanes, peak=peak, devices=devices,
                stages=[_stage(0, l_first, None, first),
                        _stage(l_before, l_end, before, end)])


def _lanes_of(state, idx):
    """``state``'s leaves at the lanes ``idx``: new tensors on its
    device."""
    return type(state)(*[tuple(x[..., idx] for x in v)
                         if isinstance(v, tuple) else v[..., idx]
                         for v in state])


def _host(state):
    return type(state)(*[tuple(x.cpu() for x in v)
                         if isinstance(v, tuple) else v.cpu()
                         for v in state])


def _stage(begin, end, before, after):
    """A stage of the check: the launches ``begin``..``end`` (indices
    since the renderer's start), the program's sampled state before them
    (None: from zero) and its sampled accumulation after them."""
    return {"begin": begin, "end": end,
            "state": None if before is None else _host(before),
            "accum": torch.stack(after.accum).cpu(),
            "count": after.count.cpu()}


def interactive(cell, run: Run, device, t_start):
    """A viewer session: ``draw_frame(pipelined=True)`` back to back with
    the schedule's drags, stills and edits applied before each frame; a
    frame's interval ends when its presented image is on the host. The
    check's frame follows the window."""
    from glaze_tpu_torch.core import Spectrum
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render import realtime
    from glaze_tpu_torch.render.realtime import RealtimeRenderer

    cfg, tr = cell.config, cell.traffic
    w, h = int(cfg["width"]), int(cfg["height"])
    parsed = parse(scene_file(cfg))
    with flatten_span(run):
        rr = RealtimeRenderer(parsed, width=w, height=h, seed=run.seed,
                              coherent=tr["coherent"], device=device)
    _held_to(cell, rr.coherent)
    rr.denoise = True
    devices = devices_of(cell, rr.device)
    lanes = reference.sample_lanes(w, h, run.seed)
    idx = torch.from_numpy(lanes).to(rr.device)
    frames = schedule.session(tr, run.seed, rr.materials(), rr.lights())
    n = [0]
    n_start = schedule.start_frames(tr, run.seed, rr.materials(),
                                    rr.lights())
    start = [None]

    def step(snap=None):
        fr = next(frames)
        if fr["strafe"]:
            rr.strafe(fr["strafe"])
        if fr["look"] is not None:
            rr.look_around(*fr["look"])
        if fr["edit"] is not None:
            mats, lights = schedule.apply_edit(fr["edit"], rr.materials(),
                                               rr.lights(), Spectrum)
            what, i = fr["edit"][:2]
            if what == "mat":
                rr.change_material(i, mats[i])
            else:
                rr.update_light(i, lights[i])
        if snap is not None:
            # after the frame's edit, which drops the display history
            _sync(devices)
            snap["before"] = _lanes_of(program_state(rr._rt), idx)
            snap["hist"] = _copy(rr._rt._dn_hist)
        rr.draw_frame(pipelined=True)
        n[0] += 1
        if n[0] == n_start:
            start[0] = _lanes_of(program_state(rr._rt), idx)

    for _ in tr["warmup"]:
        step()
    _sync(devices)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    if run.trace_on:
        from benchmark.trace import Segment

        k = int(tr["trace_frames"])
        with Segment(cell.name, [d.index for d in devices]) as seg:
            for _ in range(k):
                step()
        run.trace, run.traced_frames = seg.data, k
        t0 = time.perf_counter()
    deadline = t0 + run.seconds
    last = t0
    while True:
        step()
        now = time.perf_counter()
        if now > deadline and run.intervals:
            break
        run.intervals.append(now - last)
        last = now
    run.window_s = last - t0
    run.attempted = len(run.intervals)
    peak = _peak(devices)
    # the check's frame, the session's next: the state and the display
    # history before its launch copied, the state after it copied, and its
    # presented image taken from the draw_frame that presents it,
    # FRAMES_IN_FLIGHT frames later
    snap = {}
    step(snap)
    before, hist = snap["before"], snap["hist"]
    _sync(devices)
    st = program_state(rr._rt)
    after = _lanes_of(st, idx)
    full_accum = [a.clone() for a in st.accum]
    full_count = st.count.clone()
    if n[0] < n_start:
        start[0] = after
    for _ in range(realtime.FRAMES_IN_FLIGHT):
        image = rr.draw_frame(pipelined=True)
    image = image.copy()
    out = dict(frames=n[0], lanes=lanes, peak=peak, devices=devices,
               image=image,
               stages=[_stage(0, min(n_start, n[0]), None, start[0]),
                       _stage(n[0] - 1, n[0], before, after)],
               full_accum=full_accum, full_count=full_count, hist=hist)
    del rr
    return out


def _copy(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*map(_copy, tree)) if hasattr(tree, "_fields") \
            else tuple(map(_copy, tree))
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def reference_outputs(cell, run: Run, out: dict, ref_device,
                      precision=None) -> dict:
    """What the reference (or, with ``precision`` a context such as
    :func:`reference.bf16`, the control) makes of the run's traffic: the
    sampled lanes' ``(accum, count)`` after each of the run's check
    stages (``stages``) and, interactive, ``image``, the presented frame
    from the program's own state; ``scene``, the reference's scene."""
    cfg = cell.config
    w, h = int(cfg["width"]), int(cfg["height"])
    ref = reference.Scene(scene_file(cfg), ref_device,
                          alpha_rounds=cfg["alpha_rounds"],
                          sampler=cfg["sampler"],
                          coherent=cell.traffic["coherent"])
    stages = [{"begin": st["begin"], "end": st["end"], "state": st["state"]}
              for st in out["stages"]]
    with precision() if precision else contextlib.nullcontext():
        if cell.traffic["kind"] == "offline":
            reference.replay_offline(ref, w, h, run.seed, out["draws"],
                                     out["lanes"], stages)
            return dict(stages=[st["result"] for st in stages], scene=ref)
        stages, info = reference.replay_interactive(
            ref, w, h, run.seed, cell.traffic, run.seed, out["frames"],
            out["lanes"], stages)
        img = reference.presented_frame(
            ref, w, h, info, [a.to(ref.device) for a in out["full_accum"]],
            out["full_count"].to(ref.device),
            None if out["hist"] is None else _to(out["hist"], ref.device))
    return dict(stages=[st["result"] for st in stages], image=img,
                scene=ref)


def compare(cell, got: dict, want: dict) -> dict:
    """The checked numbers of ``got`` (the program's outputs, or the
    control's) against ``want`` (the reference's), ``{name: (value,
    limit)}``: the larger share of lanes apart of the stages, the lanes
    whose count differs in all of them, and the presented frame's pixels
    off."""
    lim = limits(cell)
    res = {}
    if "image" in want:
        res["frame_px_off_pct"] = (
            reference.pixels_off(got["image"], want["image"]),
            lim["frame_px_off_pct"])
    got_st = [(st["accum"], st["count"]) if isinstance(st, dict) else st
              for st in got["stages"]]
    found = [reference.lanes_apart(*g, *w_)
             for g, w_ in zip(got_st, want["stages"])]
    res["lanes_apart_pct"] = (max(a for a, _ in found),
                              lim["lanes_apart_pct"])
    res["count_off"] = (sum(o for _, o in found), lim["count_off"])
    return res


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device)


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start=None):
    """One run: returns (Run, the program's outputs, checks)."""
    t_start = time.perf_counter() if t_start is None else t_start
    prepare_environment(cell)
    run = Run(cell, seed, seconds, trace)
    drive = {"offline": offline, "interactive": interactive}[
        cell.traffic["kind"]]
    out = drive(cell, run, device, t_start)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference_outputs(cell, run, out, out["devices"][0])
    checks = compare(cell, out, ref)
    run.check_s = time.perf_counter() - t
    if run.capture is not None:
        from benchmark import roofline

        run.walk_least_ms = roofline.least_ms(run.capture, ref["scene"].scene)
        run.capture = None
    return run, out, checks


def correct(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


def device_info(out: dict, run: Run, chips: int) -> dict:
    dev = out["devices"][0]
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(out["peak"])}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def metric_values(cell, run: Run, trace: bool) -> dict:
    """The cell's metrics by their readers: the end-to-end ones, or with
    ``trace`` the per-layer ones; a reader that finds nothing is left
    out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cells.reader(m["name"], cell.home)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
