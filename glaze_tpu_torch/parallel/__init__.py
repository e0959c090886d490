"""Rendering over several devices (:mod:`~glaze_tpu_torch.parallel.mesh`)
and several processes (:mod:`~glaze_tpu_torch.parallel.distributed`); the
names of :mod:`glaze_tpu.parallel`."""

from glaze_tpu_torch.parallel import distributed
from glaze_tpu_torch.parallel.mesh import (
    init_state_spp,
    make_mesh,
    make_mesh_2d,
    reduce_spp,
    render_steps_2d_sharded,
    render_steps_sharded,
    render_steps_spp_sharded,
    shard_state,
    unshard_state,
)

__all__ = [
    "distributed",
    "init_state_spp",
    "make_mesh",
    "make_mesh_2d",
    "reduce_spp",
    "render_steps_2d_sharded",
    "render_steps_sharded",
    "render_steps_spp_sharded",
    "shard_state",
    "unshard_state",
]
