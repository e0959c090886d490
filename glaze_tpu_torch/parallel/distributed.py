"""Rendering across processes on ``torch.distributed`` (port of
:mod:`glaze_tpu.parallel.distributed`).

Every process runs the same program with the same seeds and renders its
own contiguous slice of the lane axis (:func:`local_pixel_slice`) over its
own devices (:func:`glaze_tpu_torch.parallel.mesh.render_steps_sharded`
with ``lanes=``). The launches need no traffic between processes; the
slices meet only when they are gathered (:func:`gather_state`) for the
image or a checkpoint, which rank 0 writes and every rank reads back.

Usage, one process per card (e.g. ``torchrun --nproc-per-node 8 ...``,
which sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``)::

    from glaze_tpu_torch.parallel import distributed
    distributed.init()                      # from torchrun's variables
    # or explicitly:
    distributed.init(coordinator="host0:29500", num_processes=2,
                     process_id=rank)
    # a renderer over a mesh then renders this process's lanes
    # (local_pixel_slice); the whole image is the gathered state
    r = RayTraceRenderer(parsed, device=distributed.local_device(),
                         mesh="auto", ...)
    r.draw(spp, return_image=False)
    whole = distributed.gather_state(r._state, r.width, r.height)

Each rank learns its place on its host, its local rank and the number of
ranks there, from ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` where the
launcher sets them, else from every rank's host name, exchanged through
the rendezvous store before the group forms (:func:`placement`). The
backend is NCCL when the host has a card for each of its ranks, and each
rank takes ``cuda:<local rank>``; otherwise it is gloo: CPU ranks, or more
ranks than cards on a host (NCCL refuses two ranks on one card), which
then share the cards in turn. Gathers under gloo cross as host tensors.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from glaze_tpu_torch.render import integrator as integ


def _env_int(name):
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


# this process's device, chosen when it joined the group
_DEVICE = None


def _local_layout(store, rank: int, world: int):
    """(local rank, ranks on this host): the launcher's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` where it set them, else counted from every
    rank's host name, exchanged through ``store``."""
    local_rank = _env_int("LOCAL_RANK")
    local_size = _env_int("LOCAL_WORLD_SIZE")
    if local_rank is not None and local_size is not None:
        return local_rank, local_size
    store.set(f"glaze_host/{rank}", socket.gethostname())
    hosts = [store.get(f"glaze_host/{i}").decode() for i in range(world)]
    return hosts[:rank].count(hosts[rank]), hosts.count(hosts[rank])


def placement(local_rank: int, local_size: int, n_cards: int):
    """(backend, device) of the rank ``local_rank`` of ``local_size`` ranks
    on a host with ``n_cards`` CUDA devices: NCCL and a card of its own
    when there is one for each rank, else gloo, on the CPU without cards
    and on the cards in turn with fewer cards than ranks."""
    if n_cards == 0:
        return "gloo", torch.device("cpu")
    device = torch.device("cuda", local_rank % n_cards)
    return ("nccl" if local_size <= n_cards else "gloo"), device


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None) -> bool:
    """Joins the process group (idempotent). ``coordinator`` is rank 0's
    ``"host:port"`` (or a rendezvous URL such as ``file:///shared/path``);
    without it the group comes from the variables that torch's launcher
    sets (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    Returns True when more than one process renders after the call; a lone
    process (neither a coordinator nor the launcher's variables, or a world
    of one) joins nothing and returns False. A process that was asked to
    join and cannot raises."""
    global _DEVICE
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None and "MASTER_ADDR" not in os.environ:
        return False
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("distributed.init needs the world size and this "
                         "process's rank (num_processes/process_id, or "
                         "WORLD_SIZE/RANK)")
    if world <= 1:
        return False
    if coordinator is None:
        url = "env://"
    elif "://" in coordinator:
        url = coordinator
    else:
        url = f"tcp://{coordinator}"
    store, rank, world = next(dist.rendezvous(url, rank=rank,
                                              world_size=world))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend, _DEVICE = placement(*_local_layout(store, rank, world), n_cards)
    dist.init_process_group(backend=backend, store=store, world_size=world,
                            rank=rank)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device():
    """This rank's device (:func:`placement`, chosen in :func:`init`); for
    a lone process ``cuda:0``, or the CPU without CUDA."""
    if dist.is_initialized() and _DEVICE is not None:
        return _DEVICE
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", 0)


def local_pixel_slice(width: int, height: int) -> slice:
    """This process's contiguous slice of the (padded, tile-swizzled) lane
    axis: an equal share each, the last rank taking the remainder."""
    p = integ.pixel_count(width, height)
    n = process_count()
    i = process_index()
    per = p // n
    return slice(i * per, (i + 1) * per if i < n - 1 else p)


def _gather_lanes(x: torch.Tensor, sizes) -> torch.Tensor:
    """Every rank's ``x`` joined along the last axis, in rank order (the
    slices may differ in length by the remainder)."""
    on_host = dist.get_backend() == "gloo"
    src = x.cpu() if on_host else x
    width = max(sizes)
    pad = torch.zeros(x.shape[:-1] + (width,), dtype=x.dtype,
                      device=src.device)
    pad[..., :x.shape[-1]] = src
    parts = [torch.empty_like(pad) for _ in sizes]
    dist.all_gather(parts, pad)
    out = torch.cat([p[..., :n] for p, n in zip(parts, sizes)], dim=-1)
    return out.to(x.device)


def gather_state(state, width: int, height: int):
    """The whole-image PathState on every rank, from each rank's state over
    its :func:`local_pixel_slice` (on the local state's device). One
    process: the state itself."""
    if process_count() == 1:
        return state
    p = integ.pixel_count(width, height)
    n = process_count()
    sizes = [p // n] * (n - 1) + [p - (p // n) * (n - 1)]
    leaves = []
    for leaf in state:
        if isinstance(leaf, tuple):
            leaves.append(tuple(_gather_lanes(t, sizes) for t in leaf))
        else:
            leaves.append(_gather_lanes(leaf, sizes))
    return integ.PathState(*leaves)


def barrier():
    """Waits for every rank (nothing to wait for in one process)."""
    if process_count() > 1:
        dist.barrier()


def shutdown():
    """Leaves the process group, if this process joined one."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None
