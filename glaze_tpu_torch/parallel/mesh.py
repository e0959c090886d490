"""Rendering over several devices: the pixel, spp and 2d modes.

Port of :mod:`glaze_tpu.parallel.mesh`. A :class:`Mesh` is an array of
torch devices with axis names. The scene is replicated, one copy per
distinct device (:func:`place_replicated`, cached), and every mode runs
each slot's launches on its own device with no traffic between devices
inside the loop:

- **pixel** (:func:`render_steps_sharded`): the lane axis (the LAST axis
  of every PathState leaf) is split into one contiguous slice per slot
  (:func:`shard_state`). A slot launches on its own lanes, with their
  global pixel coordinates, its own slice of the adaptive mask and its own
  trace sort; launch k of every slot is dispatched before launch k + 1 of
  any, so each device's queue stays fed. The sort only orders the work
  and the walks and the shading are per lane, so a sharded render is the
  unsharded one: bit for bit on a card, and on the CPU within the ulp
  that a vectorised tail loop may round a transcendental apart at another
  position of a shorter slice. The frame- and tile-coherent chains need
  nothing more (a frame shares one chain; a slice of whole 2048-lane tiles
  keeps one chain a tile, any other slice computes each lane's tile chain).
- **spp** (:func:`render_steps_spp_sharded`): every slot renders the whole
  image from its own seeds into its own state (:func:`init_state_spp`: a
  list of full-image states, one per slot, with no stacked device axis),
  and :func:`reduce_spp` sums them.
- **2d** (:func:`make_mesh_2d`, :func:`render_steps_2d_sharded`): sample
  groups x pixel slices.

A mesh may name a device more than once, or CPU devices: the CPU tests
and a one-card run use that to run n > 1 slots on one device. Several
processes (:mod:`glaze_tpu_torch.parallel.distributed`) each render their
own lane range (``lanes=``) over their own mesh.
"""

from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch

from glaze_tpu_torch.render import integrator as integ

AXIS = "pixels"
SPP_AXIS = "samples"


class Mesh:
    """Devices in an array with one name for each axis, as a
    ``jax.sharding.Mesh``: ``devices`` (an object ndarray of
    ``torch.device``), ``axis_names``, ``shape`` (name -> size) and
    ``size``."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.vectorize(_device, otypes=[object])(arr)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices.ravel()]}, "
                f"{self.shape})")


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _cuda_devices():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device: pass the mesh's devices (e.g. "
                           "['cpu'] * 4) to render on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(devices=None) -> Mesh:
    """1D mesh over ``devices`` (default: every visible CUDA device,
    ``cuda:0`` .. ``cuda:n-1``; raises without one)."""
    if devices is None:
        devices = _cuda_devices()
    return Mesh(list(devices), (AXIS,))


def make_mesh_2d(n_samples: int, devices=None) -> Mesh:
    """(samples, pixels) mesh over ``devices`` (default every visible CUDA
    device): ``n_samples`` sample groups, each over len(devices) /
    n_samples pixel slices."""
    if devices is None:
        devices = _cuda_devices()
    devices = list(devices)
    n = len(devices)
    if n % n_samples:
        raise ValueError(f"{n} devices not divisible by {n_samples} sample "
                         "groups")
    arr = np.empty((n_samples, n // n_samples), dtype=object)
    for i, d in enumerate(devices):
        arr[i // (n // n_samples), i % (n // n_samples)] = d
    return Mesh(arr, (SPP_AXIS, AXIS))


def _on(device):
    """The context that makes ``device`` current for a launch (the kernels
    launch on the current CUDA device's stream); none for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# the copies of a scene on the devices other than its own, for as long as
# the scene lives: the sharded calls take them without uploading again.
# The scene itself is never a value here, so the entry dies with it
_PLACED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def place_replicated(scene, mesh: Mesh) -> dict:
    """``{device: scene}`` with one copy of ``scene`` (a DeviceScene) on
    each distinct device of ``mesh``, ``scene`` itself on its own device.
    The copies are made once and cached with the scene, so calling it on
    every draw uploads nothing again."""
    home = _device(scene.device)
    out = {}
    for d in dict.fromkeys(mesh.devices.ravel()):
        if d == home:
            out[d] = scene
            continue
        copies = _PLACED.setdefault(scene, {})
        if d not in copies:
            copies[d] = scene.to(d)
        out[d] = copies[d]
    return out


def state_lanes(state, lanes: slice):
    """The lanes ``lanes`` of every leaf of a PathState (a process's share
    of the image)."""
    return _map_state(state, lambda x: x[..., lanes].contiguous())


def _map_state(state, fn):
    """``fn`` over every tensor leaf of a PathState."""
    return integ.PathState(*(
        tuple(fn(t) for t in leaf) if isinstance(leaf, tuple) else fn(leaf)
        for leaf in state))


def _slices(p: int, n: int):
    if p % n:
        raise ValueError(f"pixel count {p} not divisible by mesh size {n}")
    per = p // n
    return [slice(i * per, (i + 1) * per) for i in range(n)]


def shard_state(state, mesh: Mesh):
    """The PathState split over the last (lane) axis into one contiguous
    slice per slot of ``mesh`` (raises when the lanes do not divide), each
    moved to its slot's device: a list of PathStates."""
    return _shard(state, list(mesh.devices.ravel()))


def _shard(state, devices):
    sl = _slices(state.count.shape[-1], len(devices))
    return [_map_state(state, lambda x, s=s, d=d: x[..., s].to(d))
            for s, d in zip(sl, devices)]


def unshard_state(states, device=None):
    """The slices of :func:`shard_state` joined into one PathState on
    ``device`` (default: the first slice's)."""
    states = list(states)
    if device is None:
        device = states[0].count.device
    leaves = []
    for parts in zip(*states):
        if isinstance(parts[0], tuple):
            leaves.append(tuple(torch.cat([p[i].to(device) for p in parts],
                                          dim=-1)
                                for i in range(len(parts[0]))))
        else:
            leaves.append(torch.cat([p.to(device) for p in parts], dim=-1))
    return integ.PathState(*leaves)


def _coords(width: int, height: int, lanes: slice, device):
    """Global (px, py) of the lanes ``lanes`` on ``device``."""
    px, py = integ.pixel_coords(width, height, device)
    return px[lanes], py[lanes]


def _slot(device, state, px, py, sampler_seed=None, lane_active=None):
    """One slot's device, state, lane coordinates and launch inputs."""
    return dict(device=device, state=state, px=px, py=py,
                sampler_seed=sampler_seed, lane_active=lane_active)


def _run(scene, mesh, slots, seeds, offsets, cam2world, screen2cam, *,
         width, height, steps, after_launch=None, **kw):
    """``steps`` launches of every slot, launch k of all slots before
    launch k + 1 of any, each slot on its device's copy of ``scene``;
    ``seeds(k, i)`` is slot i's seed of launch k. ``kw``: the launch's
    options (:func:`integrator.launch_step`). Returns the slot states."""
    scenes = place_replicated(scene, mesh)
    size = (float(width), float(height))
    for k in range(steps):
        for i, slot in enumerate(slots):
            with _on(slot["device"]):
                slot["state"] = integ.launch_step(
                    scenes[slot["device"]], slot["state"], seeds(k, i),
                    offsets[k], cam2world, screen2cam, slot["px"],
                    slot["py"], size, sampler_seed=slot["sampler_seed"],
                    lane_active=slot["lane_active"], **kw)
            if after_launch is not None:
                after_launch(k, i, slot["state"])
    return [slot["state"] for slot in slots]


def render_steps_sharded(scene, state, seeds, offsets, cam2world, screen2cam,
                         mesh: Mesh, *, width, height, is_persp, direct_only,
                         steps, alpha_rounds=0, coherent=1, sampler="pcg",
                         sampler_seed=None, lane_active=None, lanes=None,
                         after_launch=None):
    """``steps`` launches with the lane axis split over ``mesh``'s slots.

    ``state``: a PathState over the lanes ``lanes`` of the image (a slice
    of the global lane axis; default all of it) or the list of its slices
    from :func:`shard_state`. ``scene``: a DeviceScene, placed on the
    mesh's devices once (:func:`place_replicated`). ``seeds`` (steps,) and
    ``offsets`` (steps, 2)
    NumPy, as :func:`integrator.render_steps` takes them (one sample in
    flight); ``lane_active``: the adaptive mask over the same lanes as
    ``state``. ``after_launch(k, slot, state)``, where given, runs after
    slot ``slot``'s launch k. Returns the list of slot states (join them
    with :func:`unshard_state`). The lane count must divide by the slot
    count."""
    devs = list(mesh.devices.ravel())
    n = len(devs)
    p = integ.pixel_count(width, height)
    lanes = slice(0, p) if lanes is None else lanes
    lo = 0 if lanes.start is None else lanes.start
    hi = p if lanes.stop is None else lanes.stop
    states = (_shard(state, devs) if isinstance(state, integ.PathState)
              else list(state))
    if len(states) != n:
        raise ValueError(f"{len(states)} state slices for {n} slots")
    slots = []
    for s, d, st in zip(_slices(hi - lo, n), devs, states):
        px, py = _coords(width, height, slice(lo + s.start, lo + s.stop), d)
        la = None if lane_active is None else lane_active[s].to(d)
        slots.append(_slot(d, st, px, py, sampler_seed, la))
    return _run(scene, mesh, slots, lambda k, i: int(seeds[k]), offsets,
                cam2world, screen2cam, width=width, height=height,
                steps=steps, after_launch=after_launch, is_persp=is_persp,
                direct_only=direct_only, alpha_rounds=alpha_rounds,
                coherent=coherent, sampler=sampler)


# ---------------------------------------------------------------------------
# The sample axis: every slot renders the whole image from its own seeds
# into its own state; the states are summed for display. No stacked
# device axis: the JAX package's leading axis cost it 0.69-0.73x at n = 1.


def init_state_spp(width: int, height: int, n: int, devices):
    """``n`` zero full-image PathStates, one per slot, on ``devices`` (one
    device for all, or a list of ``n``)."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} states")
    return [integ.init_state(width, height, d) for d in devices]


def _group_sampler_seeds(sampler_seed, n):
    """Per-sample-group Owen-Sobol seeds, the JAX package's formula:
    ``seed ^ g * 0x9E3779B9 ^ (g * 0x9E3779B9) >> 16`` in uint32."""
    g = np.arange(n, dtype=np.uint32) * np.uint32(0x9E3779B9)
    seed = np.uint32(0 if sampler_seed is None else int(sampler_seed)
                     & 0xFFFFFFFF)
    return [int(x) for x in seed ^ g ^ (g >> np.uint32(16))]


def _check_seeds(seeds, steps, n, what):
    seeds = np.asarray(seeds)
    if seeds.shape != (steps, n):
        raise ValueError(f"seeds must be (steps, {what})={steps, n}, got "
                         f"{seeds.shape}")
    return seeds


def render_steps_spp_sharded(scene, states, seeds, offsets, cam2world,
                             screen2cam, mesh: Mesh, *, width, height,
                             is_persp, direct_only, steps, alpha_rounds=0,
                             coherent=1, sampler="pcg", sampler_seed=0):
    """``steps`` launches in which slot i advances its own full-image state
    ``states[i]`` (:func:`init_state_spp`) with seeds ``seeds[:, i]``
    (``seeds``: (steps, n)) and its group's sampler seed
    (:func:`_group_sampler_seeds`). Returns the list of states; combine
    them with :func:`reduce_spp`."""
    devs = list(mesh.devices.ravel())
    n = len(devs)
    seeds = _check_seeds(seeds, steps, n, "n")
    if len(states) != n:
        raise ValueError(f"{len(states)} states for {n} slots")
    group_seeds = _group_sampler_seeds(sampler_seed, n)
    slots = [_slot(d, _map_state(st, lambda x, d=d: x.to(d)),
                   *integ.pixel_coords(width, height, d), group_seeds[i])
             for i, (d, st) in enumerate(zip(devs, states))]
    return _run(scene, mesh, slots, lambda k, i: int(seeds[k, i]), offsets,
                cam2world, screen2cam, width=width, height=height,
                steps=steps, is_persp=is_persp, direct_only=direct_only,
                alpha_rounds=alpha_rounds, coherent=coherent, sampler=sampler)


def reduce_spp(states, device=None):
    """One PathState from the per-slot states of the spp or 2d mode: accum
    and count summed in slot order, every other leaf slot 0's (the path
    carry, so the result reads like a PathState), on ``device`` (default
    slot 0's)."""
    states = list(states)
    if device is None:
        device = states[0].count.device
    first = _map_state(states[0], lambda x: x.to(device))
    accum, count = list(first.accum), first.count
    for st in states[1:]:
        accum = [a + b.to(device) for a, b in zip(accum, st.accum)]
        count = count + st.count.to(device)
    return first._replace(accum=tuple(accum), count=count)


def render_steps_2d_sharded(scene, states, seeds, offsets, cam2world,
                            screen2cam, mesh: Mesh, *, width, height,
                            is_persp, direct_only, steps, alpha_rounds=0,
                            coherent=1, sampler="pcg", sampler_seed=0):
    """``steps`` launches on a (samples, pixels) mesh of
    :func:`make_mesh_2d`: sample group g advances its full-image state
    ``states[g]`` (:func:`init_state_spp` with n = the group count) with
    seeds ``seeds[:, g]`` and its group's sampler seed, its lanes split
    over the group's pixel slots (every slot of a group launches with the
    group's seed, on its own lanes). Returns the list of the groups'
    full-image states, each joined on its group's first device after the
    last launch; combine them with :func:`reduce_spp`."""
    n_spp = mesh.shape[SPP_AXIS]
    n_pix = mesh.shape[AXIS]
    seeds = _check_seeds(seeds, steps, n_spp, "n_samples")
    if len(states) != n_spp:
        raise ValueError(f"{len(states)} states for {n_spp} sample groups")
    p = integ.pixel_count(width, height)
    sl = _slices(p, n_pix)
    group_seeds = _group_sampler_seeds(sampler_seed, n_spp)
    slots, groups = [], []
    for g in range(n_spp):
        devs = list(mesh.devices[g])
        for s, d, st in zip(sl, devs, _shard(states[g], devs)):
            slots.append(_slot(d, st, *_coords(width, height, s, d),
                               group_seeds[g]))
            groups.append(g)
    out = _run(scene, mesh, slots, lambda k, i: int(seeds[k, groups[i]]),
               offsets, cam2world, screen2cam, width=width, height=height,
               steps=steps, is_persp=is_persp, direct_only=direct_only,
               alpha_rounds=alpha_rounds, coherent=coherent, sampler=sampler)
    return [unshard_state([st for st, g in zip(out, groups) if g == grp],
                          mesh.devices[grp, 0]) for grp in range(n_spp)]
