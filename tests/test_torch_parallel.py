"""Rendering over several devices and processes (glaze_tpu_torch.parallel)
against glaze_tpu and against the port's unsharded render, on the CPU.

The CPU stands in for the cards: a mesh may name the CPU device several
times. A sharded launch computes every lane as the unsharded one does, but
on the CPU torch's vectorised loops finish a slice's tail with scalar
code, so a lane's transcendental may round an ulp apart when it sits at
another position of a shorter slice (measured: 62 of 4,096 lanes at most
6.9e-7 relative on the golden scene, coherent 2, 8 slots). So sharded and
unsharded renders are held to count exact and accum within rtol 1e-5,
atol 1e-6 (glaze_tpu's own sharded test's tolerance, tests/test_render.py);
on a card the expectation is bit for bit (chip_smoke.py [mesh]). Against
glaze_tpu the same tolerance holds (same seeds, same tables; XLA:CPU
rounds some products apart, ROADMAP F8).

- The pixel mode on 8 CPU slots against glaze_tpu's render_steps_sharded
  on the 8 XLA CPU devices of tests/conftest.py (coherent 1), and against
  the port's unsharded render for coherent 0/1/2, on lanes that are whole
  2,048-lane tiles and on lanes that are not.
- The spp mode (n = 4) and the 2d mode (2 x 4) against glaze_tpu's
  reduce_spp results, and the spp mode against the per-seed renders
  summed.
- Checkpoints under a mesh (tests/test_misc.py:53): a mesh render
  checkpointed and resumed on the mesh equals the uninterrupted one, and
  an unsharded checkpoint resumes on the mesh.
- The errors: samples in flight above 1, a lane count that does not divide.
- place_replicated: one copy per other device, made once, freed with the
  scene.
- distributed.init() as a no-op, local_pixel_slice, the backend and device
  of each rank (the explicit form and torchrun's variables, card counts
  faked), a renderer holding its process's lanes (a two-process group
  faked), and a two-process gloo render (rendezvous through a file under
  tmp_path) gathered and checkpointed against a single-process render.
- The CLI's --mesh --device cpu against the same command without --mesh.
- The pod tools: multihost_demo (two pod_launch processes, a checkpoint
  and its resume, against the CLI) and pod_launch's device rule.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import port_scene_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6


def _accum(state):
    if isinstance(state.accum[0], torch.Tensor):
        return torch.stack(state.accum, -1).numpy()
    return np.stack([np.asarray(a) for a in state.accum], -1)


def _count(state):
    c = state.count
    return c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def _agree(got, want):
    np.testing.assert_array_equal(_count(got), _count(want))
    np.testing.assert_allclose(_accum(got), _accum(want), rtol=RTOL,
                               atol=ATOL)
    assert np.isfinite(_accum(got)).all() and _accum(got).max() > 0


@pytest.fixture(scope="module")
def tiny():
    """(glaze_tpu scene, port scene, c2w, s2c) of the tiny scene at 16x16."""
    import __graft_entry__ as graft
    from glaze_tpu_torch.render import integrator as ti

    js, cam = graft._tiny_scene(16, 16)
    c2w, s2c = ti.camera_matrices(cam, 16, 16)
    return js, port_scene_from_jax(js, "cpu"), c2w, s2c


SEEDS = np.asarray([3, 5, 9], np.uint32)
OFFSETS = np.full((3, 2), 0.5, np.float32)


def _kw(w=16, h=16, coherent=1, steps=3):
    return dict(width=w, height=h, is_persp=True, direct_only=False,
                steps=steps, coherent=coherent)


def test_pixel_mode_matches_glaze_tpu(tiny):
    """8 slots against glaze_tpu's 8-device shard_map render, coherent 1."""
    from glaze_tpu.parallel import make_mesh as j_make_mesh
    from glaze_tpu.parallel import render_steps_sharded as j_sharded
    from glaze_tpu.render import integrator as ji
    from glaze_tpu_torch.parallel import mesh as pm
    from glaze_tpu_torch.render import integrator as ti

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 XLA CPU devices of tests/conftest.py")
    js, ts, c2w, s2c = tiny
    want = j_sharded(js, ji.init_state(16, 16), jnp.asarray(SEEDS),
                     jnp.asarray(OFFSETS), jnp.asarray(c2w), jnp.asarray(s2c),
                     j_make_mesh(jax.devices()[:8]), **_kw())
    states = pm.render_steps_sharded(
        ts, ti.init_state(16, 16, "cpu"), SEEDS, OFFSETS, c2w, s2c,
        pm.make_mesh(["cpu"] * 8), **_kw())
    assert len(states) == 8 and states[0].count.shape == (256,)
    _agree(pm.unshard_state(states), want)


@pytest.mark.parametrize("coherent", [0, 1, 2])
@pytest.mark.parametrize("size", [(16, 16), (128, 64)])
def test_pixel_mode_matches_unsharded(tiny, coherent, size):
    """8 slots of 256 lanes (16x16: part tiles) and 4 slots of one
    2,048-lane tile each (128x64) against the port's unsharded render."""
    from glaze_tpu_torch.parallel import mesh as pm
    from glaze_tpu_torch.render import integrator as ti

    _, ts, _, _ = tiny
    w, h = size
    c2w, s2c = ti.camera_matrices(_camera(), w, h)
    n = 8 if size == (16, 16) else 4
    kw = _kw(w, h, coherent)
    want = ti.render_steps(ts, ti.init_state(w, h, "cpu"), SEEDS, OFFSETS,
                           c2w, s2c, **kw)
    seen = []
    states = pm.render_steps_sharded(
        ts, ti.init_state(w, h, "cpu"), SEEDS, OFFSETS, c2w, s2c,
        pm.make_mesh(["cpu"] * n), after_launch=lambda k, i, st:
        seen.append((k, i)), **kw)
    # launch k of every slot before launch k + 1 of any
    assert seen == [(k, i) for k in range(3) for i in range(n)]
    _agree(pm.unshard_state(states), want)


def _camera():
    import __graft_entry__ as graft

    return graft._tiny_scene(16, 16)[1]


def test_lanes_and_lane_active_slices(tiny):
    """A sub-range of the lanes (``lanes=``, a process's share) with an
    adaptive mask renders those lanes of the whole render."""
    from glaze_tpu_torch.parallel import mesh as pm
    from glaze_tpu_torch.render import integrator as ti

    _, ts, c2w, s2c = tiny
    p = ti.pixel_count(16, 16)
    active = torch.from_numpy(np.arange(p) % 5 != 0)
    want = ti.render_steps(ts, ti.init_state(16, 16, "cpu"), SEEDS, OFFSETS,
                           c2w, s2c, lane_active=active, **_kw())
    lanes = slice(512, 1536)
    part = pm.shard_state(ti.init_state(16, 16, "cpu"),
                          pm.make_mesh(["cpu"] * 2))[0]  # 1,024 zero lanes
    got = pm.unshard_state(pm.render_steps_sharded(
        ts, part, SEEDS, OFFSETS, c2w, s2c, pm.make_mesh(["cpu"] * 4),
        lane_active=active[lanes], lanes=lanes, **_kw()))
    want_part = pm.shard_state(want, pm.make_mesh(["cpu"] * 4))
    _agree(got, pm.unshard_state(want_part[1:3]))
    assert (got.count.numpy() == 0).any()  # parked lanes


def _spp_pair(tiny, n_spp, two_d):
    from glaze_tpu.parallel import mesh as jm
    from glaze_tpu.render import integrator as ji
    from glaze_tpu_torch.parallel import mesh as pm

    js, ts, c2w, s2c = tiny
    seeds = np.arange(3 * n_spp, dtype=np.uint32).reshape(3, n_spp) * 7 + 1
    if two_d:
        jmesh = jm.make_mesh_2d(n_spp, jax.devices()[:8])
        j_fn, p_fn = jm.render_steps_2d_sharded, pm.render_steps_2d_sharded
        tmesh = pm.make_mesh_2d(n_spp, ["cpu"] * 8)
    else:
        jmesh = jm.make_mesh(jax.devices()[:n_spp])
        j_fn, p_fn = jm.render_steps_spp_sharded, pm.render_steps_spp_sharded
        tmesh = pm.make_mesh(["cpu"] * n_spp)
    want = jm.reduce_spp(j_fn(
        js, jm.init_state_spp(16, 16, n_spp), jnp.asarray(seeds),
        jnp.asarray(OFFSETS), jnp.asarray(c2w), jnp.asarray(s2c), jmesh,
        sampler_seed=0, **_kw()))
    states = p_fn(ts, pm.init_state_spp(16, 16, n_spp, "cpu"), seeds,
                  OFFSETS, c2w, s2c, tmesh, sampler_seed=0, **_kw())
    assert len(states) == n_spp
    return pm.reduce_spp(states), want, seeds, states


def test_spp_mode_matches_glaze_tpu_and_per_seed_renders(tiny):
    """n = 4 sample slots: glaze_tpu's reduce_spp result, and the sum of
    four unsharded renders from the slots' seeds."""
    from glaze_tpu_torch.render import integrator as ti

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 XLA CPU devices of tests/conftest.py")
    got, want, seeds, states = _spp_pair(tiny, 4, two_d=False)
    _agree(got, want)
    _, ts, c2w, s2c = tiny
    for i, st in enumerate(states):
        one = ti.render_steps(ts, ti.init_state(16, 16, "cpu"), seeds[:, i],
                              OFFSETS, c2w, s2c, **_kw())
        np.testing.assert_array_equal(_accum(st), _accum(one))
        np.testing.assert_array_equal(_count(st), _count(one))
    np.testing.assert_array_equal(_count(got), 4 * _count(states[0]))


def test_2d_mode_matches_glaze_tpu(tiny):
    """2 sample groups x 4 pixel slots against glaze_tpu's 2d mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 XLA CPU devices of tests/conftest.py")
    got, want, _, states = _spp_pair(tiny, 2, two_d=True)
    assert states[0].count.shape == (2048,)
    _agree(got, want)


def test_checkpoint_resume_under_mesh(tmp_path):
    """tests/test_misc.py:53 for the port: a mesh render checkpointed after
    2 spp and resumed on the mesh equals the uninterrupted mesh render bit
    for bit, and an unsharded checkpoint resumed on the mesh agrees within
    the CPU's sharding tolerance (its first 2 spp ran unsharded). Every
    save follows an even launch count (ROADMAP F12)."""
    from glaze_tpu_torch.parallel import make_mesh
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    import __graft_entry__ as graft

    scene = port_scene_from_jax(graft._tiny_scene(16, 16)[0], "cpu")
    camera = _camera()
    mesh = make_mesh(["cpu"] * 8)

    def renderer(use_mesh=True):
        return RayTraceRenderer(scene, camera=camera, width=16, height=16,
                                seed=9, mesh=mesh if use_mesh else None)

    r_full = renderer()
    r_full.draw(3)
    expected = r_full._state
    r1 = renderer()
    r1.draw(2)
    ckpt = str(tmp_path / "mesh_state.npz")
    r1.save_checkpoint(ckpt)
    r2 = renderer()
    r2.load_checkpoint(ckpt)
    r2.draw(1)
    np.testing.assert_array_equal(_accum(r2._state), _accum(expected))
    np.testing.assert_array_equal(r2.get_image(), r_full.get_image())
    r3 = renderer(use_mesh=False)
    r3.draw(2)
    ckpt2 = str(tmp_path / "flat_state.npz")
    r3.save_checkpoint(ckpt2)
    r4 = renderer()
    r4.load_checkpoint(ckpt2)
    r4.draw(1)
    _agree(r4._state, expected)
    # and a mesh checkpoint resumes unsharded
    r5 = renderer(use_mesh=False)
    r5.load_checkpoint(ckpt)
    r5.draw(1)
    _agree(r5._state, expected)


def test_mesh_errors(tiny):
    from glaze_tpu_torch.parallel import mesh as pm
    from glaze_tpu_torch.render import integrator as ti
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    _, ts, c2w, s2c = tiny
    with pytest.raises(ValueError, match="samples_in_flight"):
        RayTraceRenderer(ts, width=16, height=16, samples_in_flight=2,
                         mesh=pm.make_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="divisible"):
        RayTraceRenderer(ts, width=16, height=16,
                         mesh=pm.make_mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="divisible"):
        pm.render_steps_sharded(ts, ti.init_state(16, 16, "cpu"), SEEDS,
                                OFFSETS, c2w, s2c, pm.make_mesh(["cpu"] * 3),
                                **_kw())
    with pytest.raises(ValueError, match="seeds"):
        pm.render_steps_spp_sharded(
            ts, pm.init_state_spp(16, 16, 2, "cpu"), SEEDS, OFFSETS, c2w,
            s2c, pm.make_mesh(["cpu"] * 2), **_kw())
    with pytest.raises(ValueError, match="divisible"):
        pm.make_mesh_2d(3, ["cpu"] * 8)


def test_place_replicated_uploads_once(tiny):
    """One copy per distinct device, made once for the scene's life."""
    from glaze_tpu_torch.parallel import mesh as pm

    _, ts, _, _ = tiny
    mesh = pm.make_mesh(["cpu"] * 4)
    a = pm.place_replicated(ts, mesh)
    b = pm.place_replicated(ts, mesh)
    assert list(a) == [torch.device("cpu")]
    assert a[torch.device("cpu")] is ts and b[torch.device("cpu")] is ts


def test_place_replicated_frees_with_the_scene():
    """The copies on other devices are cached for as long as the scene
    lives, and the cache never holds the scene itself: dropping the scene
    drops its entry (the meta device stands in for a second card)."""
    import gc
    import weakref

    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.parallel import mesh as pm
    from glaze_tpu_torch.scene import flatten_scene

    scene, _, _ = flatten_scene(ps.MatRowScene(), "cpu")
    before = len(pm._PLACED)
    pm.place_replicated(scene, pm.make_mesh(["cpu"] * 2))
    assert len(pm._PLACED) == before  # no copy, no entry
    mesh = pm.make_mesh(["cpu", "meta", "meta"])
    a = pm.place_replicated(scene, mesh)
    b = pm.place_replicated(scene, mesh)
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert list(a) == [cpu, meta] and a[cpu] is scene
    assert a[meta] is b[meta] and a[meta].bvh.nodes16.device == meta
    assert len(pm._PLACED) == before + 1
    ref = weakref.ref(scene)
    del scene, a, b
    gc.collect()
    assert ref() is None and len(pm._PLACED) == before


class _Store:
    """The rendezvous store of a group: host names other ranks wrote."""

    def __init__(self, hosts):
        self.kv = {f"glaze_host/{i}": h.encode() for i, h in enumerate(hosts)}

    def set(self, k, v):
        self.kv[k] = v.encode()

    def get(self, k):
        return self.kv[k]


@pytest.mark.parametrize("hosts,rank,cards,env,want", [
    # the explicit form (--coordinator/--num-processes/--process-id): the
    # local rank and size come from the host names
    (["a"] * 8, 5, 8, {}, ("nccl", "cuda:5")),
    (["a"] * 8 + ["b"] * 8, 11, 8, {}, ("nccl", "cuda:3")),
    (["a"] * 16, 11, 8, {}, ("gloo", "cuda:3")),
    (["a"] * 2, 1, 1, {}, ("gloo", "cuda:0")),
    (["a"] * 2, 1, 0, {}, ("gloo", "cpu")),
    # torchrun's variables win over the host names
    (["a"] * 2, 1, 4, {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
     ("nccl", "cuda:1")),
    (["a"] * 2, 1, 1, {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
     ("gloo", "cuda:0")),
])
def test_distributed_backend_and_device(monkeypatch, hosts, rank, cards, env,
                                        want):
    """init picks NCCL and a card of the rank's own only when its host has
    a card for each of its ranks; two NCCL ranks never share a card."""
    import torch.distributed as dist

    from glaze_tpu_torch.parallel import distributed

    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr("socket.gethostname", lambda: hosts[rank])
    store = _Store(hosts)
    joined = {}
    monkeypatch.setattr(dist, "rendezvous", lambda url, rank, world_size: iter(
        [(store, rank, world_size)]))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: joined.update(kw))
    assert distributed.init(coordinator="host0:29500",
                            num_processes=len(hosts), process_id=rank)
    assert joined["backend"] == want[0] and joined["store"] is store
    assert (joined["rank"], joined["world_size"]) == (rank, len(hosts))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert distributed.local_device() == torch.device(want[1])
    monkeypatch.setattr(distributed, "_DEVICE", None)


def test_renderer_holds_its_process_lanes(tiny, tmp_path, monkeypatch):
    """Under a mesh with several processes a renderer holds and draws its
    process's local_pixel_slice: rank 1 of 2 (the group faked) renders
    those lanes of the one-process render, reads the whole image's
    checkpoint into them, and refuses draw_frame."""
    from glaze_tpu_torch.parallel import distributed, make_mesh
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    _, ts, _, _ = tiny
    camera = _camera()
    whole = RayTraceRenderer(ts, camera=camera, width=16, height=16, seed=9)
    whole.draw(2)
    ckpt = str(tmp_path / "whole.npz")
    whole.save_checkpoint(ckpt)
    whole.draw(1)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    lanes = distributed.local_pixel_slice(16, 16)
    assert lanes == slice(1024, 2048)
    mine = RayTraceRenderer(ts, camera=camera, width=16, height=16, seed=9,
                            mesh="auto")
    assert mine._mesh.size == 1 and mine._state.count.shape == (1024,)
    mine.draw(3, return_image=False)
    _agree(mine._state, _lanes_of(whole._state, lanes))
    resumed = RayTraceRenderer(ts, camera=camera, width=16, height=16,
                               mesh=make_mesh(["cpu"] * 2))
    resumed.load_checkpoint(ckpt)
    assert resumed._state.count.shape == (1024,)
    resumed.draw(1, return_image=False)
    _agree(resumed._state, _lanes_of(whole._state, lanes))
    with pytest.raises(ValueError, match="process"):
        mine.draw_frame()


def _lanes_of(state, lanes):
    from glaze_tpu_torch.parallel import mesh as pm

    return pm.state_lanes(state, lanes)


def test_distributed_lone_process(monkeypatch):
    from glaze_tpu_torch.parallel import distributed
    from glaze_tpu_torch.render import integrator as ti

    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert distributed.init() is False
    assert distributed.init() is False
    assert distributed.process_count() == 1
    p = ti.pixel_count(100, 37)
    assert distributed.local_pixel_slice(100, 37) == slice(0, p)
    assert distributed.init(coordinator="localhost:1", num_processes=1,
                            process_id=0) is False
    monkeypatch.setattr(distributed, "process_count", lambda: 3)
    got = []
    for i in range(3):
        monkeypatch.setattr(distributed, "process_index", lambda i=i: i)
        got.append(distributed.local_pixel_slice(100, 37))
    per = p // 3
    assert got == [slice(0, per), slice(per, 2 * per), slice(2 * per, p)]
    with pytest.raises(ValueError, match="rank"):
        distributed.init(coordinator="localhost:1")


WORKER = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, ROOT)
torch.set_num_threads(1)
import glaze_tpu_torch.scenes as ps
from glaze_tpu_torch.parallel import distributed, mesh as pm
from glaze_tpu_torch.render import integrator as ti
from glaze_tpu_torch.scene import flatten_scene

rank = int(sys.argv[1])
assert distributed.init(coordinator=URL, num_processes=2, process_id=rank)
assert distributed.process_count() == 2
W, H = 64, 32
scene, cam, _ = flatten_scene(ps.MatRowScene(), "cpu")
c2w, s2c = ti.camera_matrices(cam, W, H)
kw = dict(width=W, height=H, is_persp=True, direct_only=False, steps=2,
          coherent=1)
lanes = distributed.local_pixel_slice(W, H)
mesh = pm.make_mesh(["cpu"] * 2)
full = ti.init_state(W, H, "cpu")
local = pm.shard_state(full, pm.make_mesh(["cpu"] * 2))[rank]
offs = np.full((2, 2), 0.5, np.float32)
st = pm.unshard_state(pm.render_steps_sharded(
    scene, local, np.asarray([3, 5], np.uint32), offs, c2w, s2c, mesh,
    lanes=lanes, **kw))
whole = distributed.gather_state(st, W, H)
if rank == 0:
    leaves = [x.numpy() for _, x in ti.named_leaves(whole)]
    np.savez(CKPT + ".tmp.npz",
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    import os
    os.replace(CKPT + ".tmp.npz", CKPT)
distributed.barrier()
z = np.load(CKPT)
leaves = [torch.from_numpy(z[f"leaf_{i}"]) for i in range(15)]
restored = ti.PathState(leaves[0], tuple(leaves[1:4]), tuple(leaves[4:7]),
                        leaves[7], leaves[8], tuple(leaves[9:12]), leaves[12],
                        leaves[13], leaves[14])
mine = pm.shard_state(restored, pm.make_mesh(["cpu"] * 2))[rank]
st2 = pm.unshard_state(pm.render_steps_sharded(
    scene, mine, np.asarray([11, 13], np.uint32), offs, c2w, s2c, mesh,
    lanes=lanes, **kw))
whole2 = distributed.gather_state(st2, W, H)
if rank == 0:
    np.savez(OUT, accum1=torch.stack(whole.accum).numpy(),
             count1=whole.count.numpy(), accum2=torch.stack(whole2.accum).numpy(),
             count2=whole2.count.numpy())
distributed.barrier()
distributed.shutdown()
print("rank", rank, "ok")
'''


def test_two_process_gloo_render(tmp_path):
    """Two processes on gloo (rendezvous through a file under tmp_path, so
    parallel test workers never share a port) each render their
    local_pixel_slice of the golden scene at 64x32 over a 2-slot CPU mesh,
    2 launches; gathered, the image equals a one-process render. Then the
    checkpoint flow: rank 0 saves the gathered state, both reload it and
    render 2 more launches, against the straight continuation."""
    from glaze_tpu_torch.render import integrator as ti
    from glaze_tpu_torch.scene import flatten_scene

    import glaze_tpu_torch.scenes as ps

    url = "file://" + str(tmp_path / "store")
    out = str(tmp_path / "out.npz")
    code = (f"ROOT = {ROOT!r}\nURL = {url!r}\nCKPT = "
            f"{str(tmp_path / 'ck.npz')!r}\nOUT = {out!r}\n" + WORKER)
    script = tmp_path / "worker.py"
    script.write_text(code)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(v, None)
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0, 0], outs
    got = np.load(out)
    scene, cam, _ = flatten_scene(ps.MatRowScene(), "cpu")
    c2w, s2c = ti.camera_matrices(cam, 64, 32)
    kw = _kw(64, 32, steps=2)
    offs = np.full((2, 2), 0.5, np.float32)
    one = ti.render_steps(scene, ti.init_state(64, 32, "cpu"),
                          np.asarray([3, 5], np.uint32), offs, c2w, s2c, **kw)
    np.testing.assert_array_equal(got["count1"], one.count.numpy())
    np.testing.assert_allclose(got["accum1"], torch.stack(one.accum).numpy(),
                               rtol=RTOL, atol=ATOL)
    two = ti.render_steps(scene, one, np.asarray([11, 13], np.uint32), offs,
                          c2w, s2c, **kw)
    np.testing.assert_array_equal(got["count2"], two.count.numpy())
    np.testing.assert_allclose(got["accum2"], torch.stack(two.accum).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_cli_mesh_matches_without_mesh(tmp_path):
    """--mesh --device cpu (a one-slot mesh of the CPU) renders the same
    accumulation and PNG as the command without --mesh."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch import cli

    scene = tmp_path / "s.glaze"
    ps.write_glaze(ps.MatRowScene(), str(scene))
    runs = []
    for flags in ([], ["--mesh"]):
        out = tmp_path / f"o{len(runs)}.png"
        code, r, _ = cli.run([str(scene), str(out), "--device", "cpu",
                              "--res", "32x16", "--spp", "1", "--seed", "4"]
                             + flags)
        assert code == 0
        runs.append((r, out.read_bytes()))
    (plain, png0), (meshed, png1) = runs
    assert plain._mesh is None and meshed._mesh.size == 1
    np.testing.assert_array_equal(_accum(meshed._state), _accum(plain._state))
    np.testing.assert_array_equal(_count(meshed._state), _count(plain._state))
    assert png0 == png1


def test_multihost_demo_resumes_across_processes():
    """python -m glaze_tpu_torch.tools.multihost_demo: two pod_launch
    processes on the CPU render one sample with --checkpoint, two more
    resume it to two samples, and their gathered checkpoint equals the
    CLI's straight render within the CPU's sharding tolerance."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "glaze_tpu_torch.tools.multihost_demo",
         "--nproc", "2"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "multihost demo OK: 2 processes" in out.stdout


def test_pod_launch_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    """pod_launch renders on the rank's card by default and raises without
    one (no CPU fallback); one process with --device cpu renders the
    CLI's image."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch import cli
    from glaze_tpu_torch.tools import pod_launch

    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    scene = tmp_path / "s.glaze"
    ps.write_glaze(ps.MatRowScene(), str(scene))
    args = [str(scene), str(tmp_path / "p.png"), "--res", "32x16", "--spp",
            "1", "--seed", "3", "--integrator", "direct"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pod_launch.main(args)
    assert pod_launch.main(args + ["--device", "cpu"]) == 0
    code = cli.main([str(scene), str(tmp_path / "c.png"), "--res", "32x16",
                     "--spp", "1", "--seed", "3", "-i", "direct",
                     "--device", "cpu"])
    assert code == 0
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "c.png").read_bytes()
