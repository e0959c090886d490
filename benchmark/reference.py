"""The plain reference that decides ``correct``, and its comparison.

It imports nothing of ``glaze_tpu_torch``, ``glaze_tpu`` or ``jax``: it
parses the cell's ``.glaze`` itself and works out again, with the frozen
copies in :mod:`benchmark.ref`, what the program's set-up derives (tables,
trees, the opaque/alpha split, the atlas). The harness hands it only the
facts it decided itself (the seed, the draws and frames it issued and how
many launches each ran) and, to judge them, the program's outputs.

- **The accumulation** (every cell): a sample of real pixels, drawn from
  the seed, is rendered again launch by launch through every launch the
  run made (warm-up included), with the launch seeds and sub-pixel
  offsets the renderer's host generator gives for those draws, on the
  reference's own walks (:mod:`benchmark.ref.accel.blocks`). Each lane's
  ``count`` must match exactly; its ``accum`` is compared by
  :func:`lanes_apart`.
- **The presented frame** (interactive cells): the temporal denoiser's
  display of the run's last launch, worked out from the program's own
  state after that launch and its display history before it, with a
  G-buffer the reference traces itself from the launch that last
  restarted the accumulation. This stage follows the program's state,
  whose accumulation the first check covers.

:func:`bf16` runs the reference with every floating result rounded to
bfloat16: the control, the precision below the float32 the configuration
states.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from benchmark import schedule as sched_mod

# pixels whose accumulation the reference renders again; not a multiple of
# the renderer's 2048-lane tile, so the tile-coherent chains are computed
# lane by lane (the same values)
CHECK_LANES = 1000
# a lane is apart when its accumulated rgb differs from the reference's by
# more than this share of the reference's (plus the same absolute floor)
LANE_RTOL = 1e-4
# a presented pixel is off when a channel differs by more than one level
PIXEL_LEVELS = 1
_CHUNK = 32  # the renderer's launches a chunk of draw()


def chunk_sizes(total: int):
    """The renderer's chunks of a ``draw`` of ``total`` launches: the
    largest power of two up to 32 that divides it, repeated."""
    if total <= 0:
        return []
    c = _CHUNK
    while c > 1 and (c > total or total % c):
        c >>= 1
    return [c] * (total // c)


def sample_lanes(width: int, height: int, seed: int, n: int = CHECK_LANES):
    """Lane indices (sorted) of ``n`` real pixels drawn from the seed."""
    from benchmark.ref.render import integrator as integ

    px, py = integ.pixel_coords_np(width, height)
    real = np.nonzero((px < width) & (py < height))[0]
    rng = np.random.default_rng([int(seed), 0x1A7E])
    return np.sort(rng.choice(real, size=min(n, real.size), replace=False))


# calls that move or select values without computing new ones: their
# results stay as they are (tree nodes keep integer fields in float words)
_MOVES = {"__getitem__", "__setitem__", "index_select", "gather", "take",
          "view", "reshape", "contiguous", "clone", "expand", "expand_as",
          "broadcast_to", "cat", "stack", "flatten", "squeeze", "unsqueeze",
          "permute", "transpose", "narrow", "select", "split", "chunk",
          "unbind", "to", "repeat", "repeat_interleave", "where", "detach",
          "new_zeros", "new_full", "zeros_like", "ones_like", "full_like",
          "empty_like", "pad"}


class _RoundBF16(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "") in _MOVES:
            return out
        return _round(out)


def _round(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    if isinstance(x, tuple):
        return type(x)(*map(_round, x)) if hasattr(x, "_fields") else \
            tuple(map(_round, x))
    if isinstance(x, list):
        return [_round(v) for v in x]
    return x


@contextlib.contextmanager
def bf16():
    """Every float32 tensor that a torch call computes rounded to
    bfloat16 (values that are only moved or selected are kept)."""
    with _RoundBF16():
        yield


class Scene:
    """The reference's own scene: the ``.glaze`` parsed and flattened by
    the frozen copies, on ``device``, with the cell's render settings:
    ``alpha_rounds`` (re-test rounds where a material has an opacity
    map), ``sampler`` (the pcg sampler alone is replayed) and
    ``coherent`` (off, frame or tile)."""

    def __init__(self, path: str, device, alpha_rounds: int = 1,
                 sampler: str = "pcg", coherent="frame"):
        from benchmark.ref.core import Camera
        from benchmark.ref.parser import parse
        from benchmark.ref.scene import flatten as fl

        if sampler != "pcg":
            raise NotImplementedError(
                f"the reference replays the pcg sampler, not {sampler!r}")
        self.rounds, self.sampler, self.coherent = (
            int(alpha_rounds), sampler, coherent)
        self.parsed = parse(path)
        self.device = torch.device(device)
        self.scene, cam, self.host = fl.flatten_scene(self.parsed,
                                                      self.device)
        self.camera = cam if cam is not None else Camera.default()

    @property
    def alpha_rounds(self) -> int:
        """The stated re-test rounds where a material has an opacity map,
        else none."""
        return (self.rounds if any(m.opacity != 0 for m in
                                   self.host.materials) else 0)

    def edit(self, edit):
        """Applies an interactive edit as the renderer's
        ``update_materials_and_lights`` does: the material, light and sky
        tables flattened again."""
        from benchmark.ref.core import Spectrum
        from benchmark.ref.scene import flatten as fl

        mats, lights = sched_mod.apply_edit(edit, self.host.materials,
                                            self.host.lights, Spectrum)
        lights_r = fl.reorder_lights(lights)
        h = self.host
        tables = {
            **fl.flatten_materials(mats),
            **fl.flatten_lights(lights_r, h.inst_material, h.inst_tri_first,
                                h.inst_tri_count),
            **fl.build_sky_tables(lights_r, h.textures),
        }
        self.scene = self.scene._replace(
            **{k: fl.array_to(v, self.device) for k, v in tables.items()})
        self.host = h._replace(materials=list(mats), lights=lights_r)


def _zero_state(n: int, device):
    from benchmark.ref.render import integrator as integ

    def z():
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return integ.PathState(
        importance=torch.zeros((16, n), dtype=torch.float32, device=device),
        origin=(z(), z(), z()), direction=(z(), z(), z()), bounce=z(),
        last_specular=z(), accum=(z(), z(), z()), count=z(),
        path_no=torch.zeros((n,), dtype=torch.int64, device=device), sq=z())


class Lanes:
    """The sampled lanes' coordinates on ``device``."""

    def __init__(self, lanes, width: int, height: int, device):
        from benchmark.ref.render import integrator as integ

        px, py = integ.pixel_coords_np(width, height)
        self.index = np.asarray(lanes)
        self.px = torch.from_numpy(px[self.index].astype(np.float32)).to(device)
        self.py = torch.from_numpy(py[self.index].astype(np.float32)).to(device)


def _launch(ref: Scene, state, seed, offset, camera, px, py, width, height,
            want_first_hit=False):
    from benchmark.ref.render import integrator as integ

    c2w, s2c = integ.camera_matrices(camera, width, height)
    return integ.launch_step(
        ref.scene, state, int(seed), offset, c2w, s2c, px, py,
        (float(width), float(height)), is_persp=camera.is_perspective,
        direct_only=False, alpha_rounds=ref.alpha_rounds,
        coherent=ref.coherent, sampler=ref.sampler,
        want_first_hit=want_first_hit)


def _staged(stages, ref):
    """The replay's bookkeeping: ``stages`` are dicts with ``begin``,
    ``end`` (launch indices) and ``state`` (the program's sampled state
    before ``begin``, or None to start from zero at launch 0)."""
    for st in stages:
        st["result"] = None
        if st["state"] is not None:
            st["state"] = _on(st["state"], ref.device)
    return lambda j: [st for st in stages if st["begin"] <= j < st["end"]]


def _on(state, device):
    from benchmark.ref.render import integrator as integ

    return integ.PathState(*[tuple(x.to(device) for x in v)
                             if isinstance(v, tuple) else v.to(device)
                             for v in state])


def replay_offline(ref: Scene, width, height, render_seed, draws, lanes,
                   stages, launches_per_sample=6):
    """The sampled lanes through the ``draws`` ``[(spp, launches run),
    ...]`` of an offline renderer seeded with ``render_seed``: for each of
    ``stages`` (see :func:`_staged`) the lanes' ``(accum (3, L), count
    (L,))`` after its launches, set in ``stage["result"]``. Launches
    outside every stage only advance the host's seed and offset
    streams."""
    from benchmark.ref.render.scheduler import WorkScheduler

    lz = Lanes(lanes, width, height, ref.device)
    active = _staged(stages, ref)
    rng = np.random.default_rng(render_seed)
    sched = WorkScheduler()
    j = 0
    for spp, ran in draws:
        done = 0
        for n in chunk_sizes(spp * launches_per_sample):
            if done >= ran:
                break
            seeds = rng.integers(0, 2**32, size=n, dtype=np.uint32)
            offsets = sched.take(n)
            for k in range(n):
                for st in active(j):
                    if j == st["begin"]:
                        st["cur"] = (st["state"] if st["state"] is not None
                                     else _zero_state(len(lz.index),
                                                      ref.device))
                    st["cur"] = _launch(ref, st["cur"], seeds[k], offsets[k],
                                        ref.camera, lz.px, lz.py, width,
                                        height)
                    if j + 1 == st["end"]:
                        st["result"] = (torch.stack(st["cur"].accum),
                                        st["cur"].count)
                j += 1
            done += n
    return stages


def replay_interactive(ref: Scene, width, height, render_seed, params,
                       session_seed, n_frames, lanes, stages):
    """The session's ``n_frames`` frames (one launch each) on the sampled
    lanes, by ``stages`` as :func:`replay_offline`; every frame's camera
    move and edit is applied. Returns (stages, info), ``info`` holding
    what the presented-frame check needs: the last restart's seed and
    offset, the camera, and the previous frame's camera."""
    import copy

    from benchmark.ref.render.scheduler import WorkScheduler

    lz = Lanes(lanes, width, height, ref.device)
    active = _staged(stages, ref)
    rng = np.random.default_rng(render_seed)
    sched = WorkScheduler()
    camera = ref.camera
    frames = sched_mod.session(params, session_seed, ref.host.materials,
                               ref.host.lights)
    info = {}
    prev_camera = copy.deepcopy(camera)
    for i in range(n_frames):
        fr = next(frames)
        if i:
            prev_camera = copy.deepcopy(camera)
        restart = i == 0
        if sched_mod.move_camera(camera, fr):
            restart = True
        if fr["edit"] is not None:
            ref.edit(fr["edit"])
            restart = True
        if restart:
            sched.rewind()
        seed = rng.integers(0, 2**32, size=1, dtype=np.uint32)[0]
        offset = sched.take(1)[0]
        if restart:
            info["restart"] = (i, seed, offset)
        for st in active(i):
            if restart or (i == st["begin"] and st["state"] is None):
                st["cur"] = _zero_state(len(lz.index), ref.device)
            elif i == st["begin"]:
                st["cur"] = st["state"]
            st["cur"] = _launch(ref, st["cur"], seed, offset, camera, lz.px,
                                lz.py, width, height)
            if i + 1 == st["end"]:
                st["result"] = (torch.stack(st["cur"].accum),
                                st["cur"].count)
    info["camera"] = camera
    info["prev_camera"] = prev_camera
    return stages, info


def presented_frame(ref: Scene, width, height, info, accum, count, hist):
    """The temporal display (H, W, 3) uint8 of the run's last launch from
    the program's state after it (``accum`` 3 x (P,), ``count``) and its
    history before it (None where the renderer had none), with the
    reference's own G-buffer."""
    from benchmark.ref.render import denoise as dn
    from benchmark.ref.render import integrator as integ

    dev = ref.device
    px, py = integ.pixel_coords(width, height, dev)
    _, seed, offset = info["restart"]
    camera = info["camera"]
    _, fh = _launch(ref, _zero_state(px.shape[0], dev), seed, offset, camera,
                    px, py, width, height, want_first_hit=True)
    gb = dn._guides(ref.scene, fh["origin"], fh["direction"], fh["missed"],
                    fh["t"], fh["shading_normal"], fh["material_id"],
                    fh["uv"])
    if hist is None:
        hist = dn.init_history(width, height, dev)
        prev = dn.world_to_screen(camera, width, height)
    else:
        prev = dn.world_to_screen(info["prev_camera"], width, height)
    pw, ph = integ.padded_dims(width, height)
    inv = dn.lane_to_image(width, height, dev)[0]
    img, _ = dn.denoised_display_temporal(
        tuple(accum), count, gb, hist, prev, inv, ref.scene.exposure,
        width=width, height=height, pw=pw, ph=ph,
        is_persp=camera.is_perspective, iterations=4, sif=1,
        launches_per_spp=integ.PT_STEPS)
    return img[:height, :width]


def lanes_apart(accum, count, ref_accum, ref_count):
    """(share of lanes apart in %, lanes whose count differs): a lane is
    apart where its count differs or its rgb sum differs from the
    reference's by more than LANE_RTOL of it (and of 1)."""
    accum = accum.to(ref_accum.device, torch.float32)
    count = count.to(ref_count.device, torch.float32)
    d = (accum - ref_accum).abs().sum(0)
    s = ref_accum.abs().sum(0)
    off = count != ref_count
    apart = off | ~(d <= LANE_RTOL * (s + 1.0))
    return 100.0 * float(apart.double().mean()), int(off.sum())


def pixels_off(img, ref_img):
    """Share (%) of pixels where a channel differs by more than
    PIXEL_LEVELS."""
    a = torch.as_tensor(img).cpu().to(torch.int16)
    b = torch.as_tensor(ref_img).cpu().to(torch.int16)
    return 100.0 * float(((a - b).abs() > PIXEL_LEVELS).any(-1).double()
                         .mean())
