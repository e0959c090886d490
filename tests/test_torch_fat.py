"""The fat-leaf tree and the tree selection of glaze_tpu_torch against
glaze_tpu, on the CPU.

- Host tables: ``leaf_matrices``, the packed fat ``nodes16``, ``tri`` and
  the triangle order are bit-exact (random soups at T = 8/16/32 and the
  empty scene), and the per-slot coefficient table the kernels read is a
  bit-exact gather of ``leafmat``.
- The plain walkers (the CUDA kernels' plain versions) against the Pallas
  kernels in interpret mode: triangle slots exact, t within 2e-4 and u
  within 1e-3 (the soup and rays of tests/test_fat_bvh.py); any-hit flags
  exact, with ``active`` and ``t_max``. Against brute force: the same
  triangles, t within 1e-4 relative.
- ``tree_mode`` parses GLAZE_TREE / GLAZE_FATLEAF as glaze_tpu does; the
  fat and hybrid flattens of the tiny scene and of the lace scene are
  field for field equal to glaze_tpu's under the same GLAZE_TREE; fat and
  hybrid renders agree with glaze_tpu's (count exact, accum within 1e-4;
  the lace scene's per-pixel MAD below 1e-5).
- The shadow trace walks ``bvh_any`` on a hybrid scene.
- The kernels themselves run only on a card:
  test_fat_kernels_match_plain_on_cuda, and chip_smoke.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_bvh import _brute_force, _random_soup  # noqa: E402
from test_torch_alpha import LaceScene  # noqa: E402
from test_torch_scene import _tiny_parsed, _write  # noqa: E402
from torch_parity import jax_scene_to_numpy  # noqa: E402


def _soup_rays(n_tri, seed, n_rays):
    tri, rng = _random_soup(n_tri, seed=seed)
    o = rng.uniform(-15, 15, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tri, o, d


def _aimed_rays(tri, n, seed):
    """Rays from random points towards random points of the triangles (most
    of them hit something)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, len(tri), n)
    w = rng.dirichlet(np.ones(3), n).astype(np.float32)
    target = np.einsum("nk,nkc->nc", w, tri[k])
    o = rng.uniform(-15, 15, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# host tables


@pytest.mark.parametrize("leaf", [8, 16, 32])
def test_fat_tables_bit_exact(leaf):
    from glaze_tpu.accel.fat import build_bvh_fat as j_build
    from glaze_tpu.accel.fat import leaf_matrices as j_leaf
    from glaze_tpu_torch.accel import fat

    tri, _, _ = _soup_rays(300, 40 + leaf, 1)
    jb, j_order = j_build(tri, leaf_size=leaf)
    fields, order = fat.build_bvh_fat_np(tri, leaf)
    assert np.array_equal(j_order, order) and order.dtype == np.uint32
    for k in ("nodes", "tri", "nodes16", "leafmat"):
        a = np.asarray(getattr(jb, k))
        assert a.shape == fields[k].shape, k
        assert np.array_equal(a.view(np.int32), fields[k].view(np.int32)), k
    assert (jb.n_nodes, jb.n_tris, jb.leaf_size) == (
        fields["n_nodes"], fields["n_tris"], fields["leaf_size"])
    rows = fields["tri"]
    assert np.array_equal(j_leaf(rows, leaf).view(np.int32),
                          fat.leaf_matrices(rows, leaf).view(np.int32))


def test_fat_empty_scene_bit_exact():
    from glaze_tpu.accel.fat import build_bvh_fat as j_build
    from glaze_tpu_torch.accel import fat

    empty = np.zeros((0, 3, 3), np.float32)
    jb, j_order = j_build(empty)
    fields, order = fat.build_bvh_fat_np(empty)
    assert j_order.shape == order.shape == (0,)
    for k in ("nodes", "tri", "nodes16", "leafmat"):
        assert np.array_equal(np.asarray(getattr(jb, k)).view(np.int32),
                              fields[k].view(np.int32)), k
    b = fat.fat_from_np(fields, "cpu")
    o = _t(np.zeros((4, 3), np.float32))
    d = _t(np.tile(np.float32([0, 0, 1]), (4, 1)))
    out = fat.closest_hit_fat(b, o, d)
    assert (out["tri"] == -1).all() and torch.isinf(out["t"]).all()
    assert not fat.any_hit_fat(b, o, d, torch.full((4,), 1e9)).any()


def test_coef_table_is_a_gather_of_leafmat():
    """The kernels' (L*T, 20) table holds, bit for bit, slab entries
    (block, row) of COEF_TERMS of each slot's column, then a zero."""
    from glaze_tpu_torch.accel import fat

    tri, _, _ = _soup_rays(200, 41, 1)
    fields, _ = fat.build_bvh_fat_np(tri, 16)
    b = fat.fat_from_np(fields, "cpu")
    lm = fields["leafmat"].reshape(-1, fat.F, 4, 16)  # (L, row, blk, col)
    want = np.zeros((lm.shape[0], 16, fat.COEF_W), np.float32)
    for i, (blk, row) in enumerate(fat.COEF_TERMS):
        want[:, :, i] = lm[:, row, blk, :]
    got = b.coef.numpy()
    assert got.shape == (fields["tri"].shape[0], fat.COEF_W)
    assert np.array_equal(got.view(np.int32), want.reshape(-1, fat.COEF_W)
                          .view(np.int32))
    # every slab entry outside COEF_TERMS is zero (rows 10.. hold only the
    # base index in row 10, column 0, which feature 10 = 0 never reads)
    kept = np.zeros((fat.F, 4), bool)
    for blk, row in fat.COEF_TERMS:
        kept[row, blk] = True
    rest = lm.transpose(0, 1, 2, 3).copy()
    rest[:, kept, :] = 0.0
    rest[:, 10, 0, 0] = 0.0
    assert not rest.any()


# ---------------------------------------------------------------------------
# plain walkers


def test_plain_walkers_vs_pallas_interpret():
    """tests/test_fat_bvh.py's soup (600 triangles, T = 32, 300 rays)
    through glaze_tpu's Pallas kernels in interpret mode and the port's
    plain walkers on the same tables."""
    from glaze_tpu.accel.fat import build_bvh_fat as j_build
    from glaze_tpu.accel.traverse_fat import (any_hit_fat_pallas,
                                              closest_hit_fat_pallas)
    from glaze_tpu_torch.accel import fat

    tri, o, d = _soup_rays(600, 13, 300)
    o2, d2 = _aimed_rays(tri, 100, 43)
    o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    jb, _ = j_build(tri, leaf_size=32)
    b, _ = fat.build_bvh_fat(tri, "cpu", 32)

    ref = closest_hit_fat_pallas(jb, jnp.asarray(o), jnp.asarray(d),
                                 interpret=True)
    got = fat.closest_hit_fat(b, _t(o), _t(d))
    rt = np.asarray(ref["tri"])
    np.testing.assert_array_equal(got["tri"].numpy(), rt)
    hit = rt >= 0
    assert hit.sum() > 80
    np.testing.assert_allclose(got["t"].numpy()[hit], np.asarray(ref["t"])[hit],
                               rtol=2e-4, atol=1e-4)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k].numpy()[hit],
                                   np.asarray(ref[k])[hit], rtol=1e-3,
                                   atol=1e-3)
    assert np.isinf(got["t"].numpy()[~hit]).all()

    t_max = np.full(len(o), 12.0, np.float32)
    act = np.arange(len(o)) % 3 != 0
    ref_a = np.asarray(any_hit_fat_pallas(
        jb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        active=jnp.asarray(act), interpret=True))
    got_a = fat.any_hit_fat(b, _t(o), _t(d), _t(t_max), active=_t(act))
    np.testing.assert_array_equal(got_a.numpy(), ref_a)
    assert 0 < ref_a.sum() < act.sum() and not got_a.numpy()[~act].any()


def test_plain_walkers_vs_brute_force():
    from glaze_tpu_torch.accel import fat

    tri, o, d = _soup_rays(300, 11, 256)
    o2, d2 = _aimed_rays(tri, 256, 44)
    o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    b, order = fat.build_bvh_fat(tri, "cpu", 16)
    res = fat.closest_hit_fat(b, _t(o), _t(d))
    t, slot = res["t"].numpy(), res["tri"].numpy()
    bt, btri = _brute_force(tri, o, d)
    hit = bt != np.inf
    assert hit.sum() > 200
    assert ((t == np.inf) == ~hit).all()
    np.testing.assert_allclose(t[hit], bt[hit], rtol=1e-4, atol=1e-5)
    mapped = np.where(slot >= 0, order[np.clip(slot, 0, len(order) - 1)], -1)
    assert (mapped[hit] == btri[hit]).all()

    bt3, _ = _brute_force(tri, o, d, t_min=1e-3)
    far = fat.any_hit_fat(b, _t(o), _t(d), torch.full((len(o),), 1e30))
    assert (far.numpy() == (bt3 != np.inf)).all()
    near = np.where(np.isinf(bt3), 1.0, bt3 * 0.5).astype(np.float32)
    assert not fat.any_hit_fat(b, _t(o), _t(d), _t(near)).any()


def test_walk_stats_count_columns():
    from glaze_tpu_torch.accel import fat
    from glaze_tpu_torch.accel.bvh import WalkStats

    tri, _, _ = _soup_rays(300, 11, 1)
    o, d = _aimed_rays(tri, 200, 45)
    b, _ = fat.build_bvh_fat(tri, "cpu", 16)
    sc, sa = WalkStats(), WalkStats()
    fat.closest_hit_fat(b, _t(o), _t(d), stats=sc)
    hit = fat.any_hit_fat(b, _t(o), _t(d), torch.full((200,), 1e30), stats=sa)
    assert sc.node_visits >= 200 and sc.col_tests % 16 == 0
    assert 0 < sc.distinct("coef") <= b.coef.shape[0]
    assert 0 < sc.distinct("nodes") <= sc.node_visits
    # any hit stops at its first blocking column
    assert int(hit.sum()) > 100 and 0 < sa.col_tests < sc.col_tests


# ---------------------------------------------------------------------------
# tree selection and dispatch


@pytest.mark.parametrize("tree,legacy", [
    (None, None), ("classic", None), ("fat", None), ("hybrid", None),
    ("bogus", None), (None, "1"), (None, "0"), (None, "2"), ("hybrid", "0"),
    ("", "1"),
])
def test_tree_mode_parsing(tree, legacy, monkeypatch):
    import glaze_tpu.accel as ja
    import glaze_tpu_torch.accel as ta

    for name, v in (("GLAZE_TREE", tree), ("GLAZE_FATLEAF", legacy)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    assert ta.tree_mode() == ja.tree_mode()


def test_fat_budget_falls_back_to_classic(monkeypatch):
    """A fat node slab beyond the budget builds the classic tree in both
    packages."""
    import glaze_tpu.accel as ja
    import glaze_tpu_torch.accel as ta

    tri, _, _ = _soup_rays(200, 46, 1)
    monkeypatch.setenv("GLAZE_TREE", "hybrid")
    for pkg in (ja, ta):
        monkeypatch.setattr(pkg, "_FAT_NODES_BUDGET", 1024)
    jb, j_order, j_any = ja.build_bvh_auto(tri)
    fields, order, any_fields = ta.build_bvh_auto_np(tri)
    assert not isinstance(jb, ja.FatBVH) and "leafmat" not in fields
    assert j_any is None and any_fields is None
    assert np.array_equal(np.asarray(j_order), order)


def test_masked_dispatch_on_fat_tree(monkeypatch):
    """A fat tree has no payload: the masked closest hit is the plain one
    with mixed = tri >= 0, the masked any hit (zeros, hit), and
    masked_anyhit_ok is False, as in glaze_tpu."""
    import glaze_tpu.accel as ja
    import glaze_tpu_torch.accel as ta

    tri, _, _ = _soup_rays(300, 47, 1)
    o, d = _aimed_rays(tri, 128, 48)
    monkeypatch.setenv("GLAZE_TREE", "fat")
    b, _, b_any = ta.build_bvh_auto(tri, "cpu", 16)
    jb, _, j_any = ja.build_bvh_auto(tri, 16)
    assert isinstance(b, ta.FatBVH) and b_any is None and j_any is None
    assert not ta.masked_anyhit_ok(b) and not ja.masked_anyhit_ok(jb)
    o3 = tuple(_t(o[:, i]) for i in range(3))
    d3 = tuple(_t(d[:, i]) for i in range(3))
    plain = ta.closest_hit_soa_auto(b, o3, d3)
    masked = ta.closest_hit_soa_masked_auto(b, o3, d3)
    for k in ("t", "tri", "u", "v"):
        assert torch.equal(masked[k], plain[k]), k
    assert torch.equal(masked["mixed"], plain["tri"] >= 0)
    assert bool(masked["mixed"].any())
    cap = torch.full((128,), 1e30)
    blocked, pending = ta.any_hit_soa_masked_auto(b, o3, d3, cap)
    assert not blocked.any()
    assert torch.equal(pending, ta.any_hit_soa_auto(b, o3, d3, cap))
    jo3 = tuple(jnp.asarray(o[:, i]) for i in range(3))
    jd3 = tuple(jnp.asarray(d[:, i]) for i in range(3))
    jbl, jpe = ja.any_hit_soa_masked_auto(jb, jo3, jd3, jnp.asarray(cap.numpy()))
    assert not np.asarray(jbl).any()
    assert np.array_equal(np.asarray(jpe), pending.numpy())


def test_fat_wrappers_refuse_cpu_tensors(monkeypatch):
    """The fat kernels' wrappers launch or raise: CPU rays are an error,
    and so is a failed build."""
    from glaze_tpu_torch.accel import fat, traverse_cuda as tc

    tri = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    b, _ = fat.build_bvh_fat(tri, "cpu", 8)
    o3 = tuple(torch.zeros(4) for _ in range(3))
    d3 = (torch.zeros(4), torch.zeros(4), torch.ones(4))
    before = (tc.closest_hit_fat_soa.launches, tc.any_hit_fat_soa.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tc.closest_hit_fat_soa(b, o3, d3)
    with pytest.raises(ValueError, match="CUDA"):
        tc.any_hit_fat_soa(b, o3, d3, torch.ones(4))
    assert (tc.closest_hit_fat_soa.launches,
            tc.any_hit_fat_soa.launches) == before
    monkeypatch.setattr(tc, "_lib", None)
    monkeypatch.setattr(tc, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(tc, "_SO", os.path.join(str(tc.BUILD_DIR), "absent.so"))
    with pytest.raises(RuntimeError, match="nvcc"):
        tc._load()
    tc.reset_launch_counts()
    assert tc.closest_hit_fat_soa.launches == tc.any_hit_fat_soa.launches == 0


def test_build_follows_every_csrc_source(monkeypatch, tmp_path):
    """build() rebuilds when any file under csrc/ is newer than the
    library (here: tries nvcc, which this machine lacks)."""
    from glaze_tpu_torch.accel import traverse_cuda as tc

    src = tmp_path / "csrc"
    src.mkdir()
    (src / "traverse.cu").write_text("//")
    (src / "extra.cuh").write_text("//")
    so = tmp_path / "lib.so"
    so.write_text("")
    os.utime(src / "traverse.cu", (1000, 1000))
    os.utime(so, (2000, 2000))
    os.utime(src / "extra.cuh", (1000, 1000))
    monkeypatch.setattr(tc, "CSRC", str(src))
    monkeypatch.setattr(tc, "_SO", str(so))
    assert tc.build() == str(so)  # up to date: no compiler needed
    os.utime(src / "extra.cuh", (3000, 3000))
    monkeypatch.setattr(tc, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        tc.build()


# ---------------------------------------------------------------------------
# scene upload, integrator and renders


def _jax_flatten(src, mode, monkeypatch):
    from glaze_tpu.scene.flatten import flatten_scene

    monkeypatch.setenv("GLAZE_TREE", mode)
    js, cam, _ = flatten_scene(src)
    return js, cam


def _compare_fields(jf, tf):
    assert sorted(jf) == sorted(tf)
    for key in sorted(jf):
        a, b = jf[key], tf[key]
        if isinstance(a, int):
            assert a == b, key
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, key
        assert a.tobytes() == b.tobytes(), key  # bitwise


@pytest.mark.parametrize("mode", ["fat", "hybrid"])
@pytest.mark.parametrize("name", ["tiny", "lace"])
def test_flatten_fat_hybrid_bit_exact(name, mode, monkeypatch, tmp_path):
    from glaze_tpu.accel import FatBVH
    from glaze_tpu.parser import Serializer as JSerializer
    from glaze_tpu_torch.parser import parse as tparse
    from glaze_tpu_torch.scene.flatten import (device_scene_from_numpy,
                                               device_scene_to_numpy,
                                               flatten_scene_np)

    if name == "tiny":
        src = _tiny_parsed()
        path = tmp_path / "tiny.glaze"
        _write(JSerializer, src, path)
        port_src = tparse(str(path))
    else:
        src, port_src = LaceScene("jax"), LaceScene("torch")
    js, _ = _jax_flatten(src, mode, monkeypatch)
    assert isinstance(js.bvh, FatBVH)
    assert (js.bvh_any is not None) == (mode == "hybrid")
    tf, _, _ = flatten_scene_np(port_src)
    jf = jax_scene_to_numpy(js)
    assert "bvh.leafmat" in tf and ("bvh_any.nodes" in tf) == (mode == "hybrid")
    assert tf["bvh.tri"].shape[1] == 9  # a fat tree carries no payload
    _compare_fields(jf, tf)
    scene = device_scene_from_numpy(tf, "cpu")
    _compare_fields(tf, device_scene_to_numpy(scene))


def test_any_hit_sorted_walks_bvh_any(monkeypatch):
    """The NEE shadow trace of a hybrid scene walks its classic any-hit
    tree, as glaze_tpu's does (integrator.py _any_hit_sorted)."""
    import glaze_tpu_torch.accel as ta
    from glaze_tpu_torch.accel import BVH, FatBVH
    from glaze_tpu_torch.render import integrator as ti
    from glaze_tpu_torch.scene import flatten_scene

    monkeypatch.setenv("GLAZE_TREE", "hybrid")
    scene, _, _ = flatten_scene(_tiny_parsed(), "cpu")
    assert isinstance(scene.bvh, FatBVH) and isinstance(scene.bvh_any, BVH)
    seen = []
    orig = ta.any_hit_soa_auto

    def spy(bvh, *args, **kw):
        seen.append(bvh)
        return orig(bvh, *args, **kw)

    monkeypatch.setattr(ta, "any_hit_soa_auto", spy)
    rng = np.random.default_rng(49)
    o = tuple(_t(rng.uniform(-1, 1, 64).astype(np.float32)) for _ in range(3))
    d = tuple(_t(rng.normal(size=64).astype(np.float32)) for _ in range(3))
    ti._any_hit_sorted(scene, o, d, 5.0, torch.ones(64, dtype=torch.bool))
    assert len(seen) == 1 and seen[0] is scene.bvh_any


RW = RH = 16


def _render_pair(js, cam, ts, alpha_rounds=0):
    """Two launches of both packages' render_steps from the same seeds."""
    from glaze_tpu.render import integrator as ji
    from glaze_tpu_torch.render import integrator as ti

    c2w, s2c = ji.camera_matrices(cam, RW, RH)
    seeds = np.asarray([3, 5], np.uint32)
    offsets = np.full((2, 2), 0.5, np.float32)
    kw = dict(width=RW, height=RH, is_persp=True, direct_only=False, steps=2,
              alpha_rounds=alpha_rounds, coherent=1)
    a = ji.render_steps(js, ji.init_state(RW, RH), jnp.asarray(seeds),
                        jnp.asarray(offsets), jnp.asarray(c2w),
                        jnp.asarray(s2c), **kw)
    b = ti.render_steps(ts, ti.init_state(RW, RH, "cpu"), seeds, offsets,
                        c2w, s2c, **kw)
    np.testing.assert_array_equal(b.count.numpy(), np.asarray(a.count))
    return (np.stack([np.asarray(x) for x in a.accum], -1),
            torch.stack(b.accum, -1).numpy())


@pytest.mark.parametrize("mode", ["fat", "hybrid"])
def test_fat_hybrid_render_vs_jax(mode, monkeypatch):
    """The tiny scene, 16x16, two launches: count exact, accum within 1e-4
    (the fat closest hit is glaze_tpu's XLA fallback there, scalar
    Moller-Trumbore: ROADMAP F10)."""
    from glaze_tpu_torch.accel import FatBVH
    from glaze_tpu_torch.scene import flatten_scene

    src = _tiny_parsed()
    js, cam = _jax_flatten(src, mode, monkeypatch)
    ts, _, _ = flatten_scene(src, "cpu")
    assert isinstance(ts.bvh, FatBVH)
    assert (ts.bvh_any is not None) == (mode == "hybrid")
    a, b = _render_pair(js, cam, ts)
    assert np.isfinite(b).all() and a.max() > 0
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_lace_fat_render_vs_jax(monkeypatch):
    """The lace scene (opacity map) under GLAZE_TREE=fat: the main tree
    carries no cell masks, so both packages take the opaque/alpha split
    legs. One sample (6 launches), 32x16: count exact, clipped per-pixel
    MAD below 1e-5 (measured 7.3e-9: the split legs walk the same classic
    subset trees, so only float rounding differs)."""
    from glaze_tpu.render.renderer import RayTraceRenderer as JRenderer
    from glaze_tpu_torch.accel import FatBVH
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    monkeypatch.setenv("GLAZE_TREE", "fat")
    jr = JRenderer(LaceScene("jax"), width=32, height=16, seed=31, coherent=1)
    tr = RayTraceRenderer(LaceScene("torch"), width=32, height=16, seed=31,
                          coherent=1, device="cpu")
    assert isinstance(tr.scene.bvh, FatBVH) and tr._alpha_rounds == 1
    jr.draw(1, return_image=False)
    tr.draw(1, return_image=False)
    cj, ct = np.asarray(jr._state.count), tr._state.count.numpy()
    np.testing.assert_array_equal(ct, cj)
    aj = np.stack([np.asarray(c) for c in jr._state.accum], -1)
    at = torch.stack(tr._state.accum, -1).numpy()
    ca = np.clip(at / np.maximum(ct, 1.0)[:, None], 0.0, 1.0)
    cg = np.clip(aj / np.maximum(cj, 1.0)[:, None], 0.0, 1.0)
    mad = np.abs(ca - cg).mean()
    print(f"lace fat render: per-pixel MAD {mad:.3g}")
    assert cg.mean() > 1e-3 and mad < 1e-5


@pytest.mark.cuda
def test_fat_kernels_match_plain_on_cuda():
    """Needs a CUDA card (skips here): K7c and K7a against their plain
    versions on the same CUDA tensors, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from glaze_tpu_torch.accel import fat, traverse_cuda as tc

    tri, o, d = _soup_rays(600, 13, 300)
    o2, d2 = _aimed_rays(tri, 700, 50)
    o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    b = fat.build_bvh_fat(tri, "cpu", 32)[0].to("cuda")
    o_t, d_t = _t(o).cuda(), _t(d).cuda()
    o3 = tuple(o_t[:, i].contiguous() for i in range(3))
    d3 = tuple(d_t[:, i].contiguous() for i in range(3))
    rng = np.random.default_rng(51)
    tm = _t(rng.uniform(0.5, 30.0, len(o)).astype(np.float32)).cuda()
    act = _t(rng.uniform(size=len(o)) > 0.25).cuda()
    for cap in (None, tm):
        k = tc.closest_hit_fat_soa(b, o3, d3, cap)
        p = fat.closest_hit_fat(b, o_t, d_t, cap)
        for key in ("t", "tri", "u", "v"):
            assert torch.equal(k[key], p[key]), key
        assert bool((k["tri"] >= 0).any())
    kh = tc.any_hit_fat_soa(b, o3, d3, tm, active=act)
    assert torch.equal(kh, fat.any_hit_fat(b, o_t, d_t, tm, active=act))
    assert bool(kh.any()) and not bool(kh[~act].any())


@pytest.mark.parametrize("opacity,mode,want", [
    (False, "classic", dict(closest_hit=1, any_hit=1)),
    (False, "fat", dict(closest_hit_fat=1, any_hit_fat=1)),
    (False, "hybrid", dict(closest_hit_fat=1, any_hit=1)),
    (True, "classic", dict(closest_hit_masked=4, any_hit_masked=1)),
    (True, "fat", dict(closest_hit=1, closest_hit_masked=4, any_hit=1)),
])
def test_walks_per_launch(opacity, mode, want, monkeypatch):
    """The walks one launch makes, by kind, for each render chip_smoke.py
    checks on the card (its EXPECTED_* counts are these times 12): the
    lace scene stands for the benchmark scene (both have MIXED curtain
    triangles), without its opacity map for the opaque one. On the CPU
    each kernel's plain walker runs where the kernel would launch."""
    import glaze_tpu_torch.accel as ta
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    monkeypatch.setenv("GLAZE_TREE", mode)
    r = RayTraceRenderer(LaceScene("torch", opacity=opacity), width=16,
                         height=8, seed=3, device="cpu")
    counts = {}
    for kernel, walker in (("closest_hit", "closest_hit"),
                           ("any_hit", "any_hit"),
                           ("closest_hit_masked", "closest_hit_masked"),
                           ("any_hit_masked", "any_hit_masked"),
                           ("closest_hit_fat", "closest_hit_fat"),
                           ("any_hit_fat", "any_hit_fat")):
        def spy(*args, _orig=getattr(ta, walker), _k=kernel, **kw):
            counts[_k] = counts.get(_k, 0) + 1
            return _orig(*args, **kw)

        monkeypatch.setattr(ta, walker, spy)
    r.draw(1, return_image=False)
    assert counts == {k: 6 * n for k, n in want.items()}
