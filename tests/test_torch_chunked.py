"""The chunked BVH forest and the BVH disk cache of glaze_tpu_torch against
glaze_tpu, on the CPU.

- ``build_bvh_chunked_np`` splits a 3,000-triangle soup at max_tris=700
  into the same chunks as glaze_tpu's ``build_bvh_chunked``: chunk count,
  offsets, every chunk's tables and the global order, bit for bit.
- The four chunked dispatchers (the golden scene's triangles in a 4-chunk
  forest; the masked ones with cell masks) against glaze_tpu's on the rays
  of tests/test_torch_traverse.py: the source triangle equal
  except exact-t ties (ROADMAP F3), t/u/v within ROADMAP F8's bound (99%
  within 1e-5, all within 1e-4; t within 1e-5 relative), any-hit flags
  exact, and lanes outside
  ``active`` never blocked. With a cap, glaze_tpu walks the chunks after
  one that missed uncapped; once hits beyond the cap are culled, as the
  integrator culls them, both agree.
- Whole renders with CHUNK_MAX_TRIS lowered in both packages (the tiny
  scene, and the golden scene with an opacity map) on the classic tree and
  under GLAZE_TREE=hybrid: count exact, accum within the tolerances the
  port's other whole-render tests use (1e-4 on the tiny scene as in
  tests/test_torch_fat.py; a clipped per-pixel MAD below 1e-5 and the mean
  within 3% on the golden scene, as tests/test_torch_alpha.py).
- Opacity edits on a chunked scene: tables equal glaze_tpu's after the
  same edit and a fresh renderer's, bit for bit.
- The disk cache: a round trip is bit-exact, another soup gets another
  key, GLAZE_CACHE_DIR=0 writes nothing, nothing is written below
  CACHE_MIN_TRIS, glaze_tpu's file in the same directory is never read,
  and a damaged file means a rebuild, not an error.

A test that lowers CHUNK_MAX_TRIS sets both packages' module globals
(both read it at call time); no module is reloaded (ROADMAP F11).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_bvh import _random_soup  # noqa: E402
from test_torch_alpha import LaceScene  # noqa: E402
from test_torch_edit import _tables_equal  # noqa: E402
from test_torch_scene import _tiny_parsed  # noqa: E402
from torch_parity import jax_scene_to_numpy, jax_tree_to_numpy  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lower_chunk_limit(monkeypatch, n):
    import glaze_tpu.accel.bvh as jb
    import glaze_tpu_torch.accel.bvh as tb

    monkeypatch.setattr(jb, "CHUNK_MAX_TRIS", n)
    monkeypatch.setattr(tb, "CHUNK_MAX_TRIS", n)


def _aimed_rays(tri, n, seed):
    """Rays from random points towards random points of the triangles."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, len(tri), n)
    w = rng.dirichlet(np.ones(3), n).astype(np.float32)
    target = np.einsum("nk,nkc->nc", w, tri[k])
    o = rng.uniform(-15, 15, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


# ---------------------------------------------------------------------------
# the forest's tables


@pytest.fixture(scope="module")
def forest():
    """(glaze_tpu forest, port host forest, order, soup) of a 3,000-triangle
    soup at max_tris=700, both carrying the same random cell masks."""
    from glaze_tpu.accel import bvh as jb
    from glaze_tpu_torch.accel import bvh as tb

    tri, _ = _random_soup(3000, seed=41)
    jf, jorder = jb.build_bvh_chunked(tri, max_tris=700)
    tf, torder = tb.build_bvh_chunked_np(tri, max_tris=700)
    rows = sum(c["tri"].shape[0] for c in tf["chunks"])
    codes = np.random.default_rng(42).choice(
        3, size=(rows, 64), p=[0.3, 0.5, 0.2]).astype(np.int8)
    payload = tb.pack_alpha_masks(codes)
    return (jf, jb.attach_tri_payload(jf, payload), tf,
            tb.attach_tri_payload(tf, payload), np.asarray(jorder), torder,
            tri)


@pytest.fixture(scope="module")
def golden_forest():
    """(glaze_tpu forest, port host forest, rays) of the golden scene's
    triangles at max_tris=700, both forests carrying the same random cell
    masks; the rays are tests/test_torch_traverse.py's (the golden view's
    camera rays and random rays inside the scene), on which ROADMAP F8's
    bound was measured."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu.accel import bvh as jb
    from glaze_tpu_torch.accel import bvh as tb
    from glaze_tpu_torch.scene.flatten import flatten_scene_np
    from test_torch_traverse import _rays

    fields, cam, _ = flatten_scene_np(ps.MatRowScene())
    tri = fields["tri_pos_orig"].reshape(-1, 3, 3)
    jf, _ = jb.build_bvh_chunked(tri, max_tris=700)
    tf, _ = tb.build_bvh_chunked_np(tri, max_tris=700)
    assert len(tf["chunks"]) == 4
    rows = sum(c["tri"].shape[0] for c in tf["chunks"])
    codes = np.random.default_rng(42).choice(
        3, size=(rows, 64), p=[0.3, 0.5, 0.2]).astype(np.int8)
    payload = tb.pack_alpha_masks(codes)
    return (jf, jb.attach_tri_payload(jf, payload), tf,
            tb.attach_tri_payload(tf, payload), _rays(cam))


def test_chunked_tables_bit_exact(forest):
    from glaze_tpu_torch.accel import bvh as tb

    jf, jpay, tf, tpay, jorder, torder, tri = forest
    assert len(tf["chunks"]) == len(jf.chunks) == 8
    assert list(tf["offsets"]) == list(jf.offsets)
    assert tf["n_tris"] == jf.n_tris == 3000
    for j, t in ((jf, tf), (jpay, tpay)):
        a, b = jax_tree_to_numpy("bvh", j), _flat(t)
        assert sorted(a) == sorted(b)
        for key in sorted(a):
            assert np.asarray(a[key]).tobytes() == np.asarray(b[key]).tobytes(), key
    assert jorder.tobytes() == torder.tobytes()
    real = np.sort(torder[torder != tb.SENTINEL])
    assert np.array_equal(real, np.arange(3000))
    # a scene at the limit stays one tree, read at call time
    one, _ = tb.build_bvh_chunked_np(tri[:700], max_tris=700)
    assert "chunks" not in one


def _flat(tree):
    from glaze_tpu_torch.scene.flatten import _flat_tree

    return _flat_tree("bvh", tree)


def _closest_equal(port, ref, label, masked):
    """Source triangle exact except exact-t ties (F3); t/u/v within F8."""
    tri_p, tri_r = port["tri"].numpy(), np.asarray(ref["tri"])
    t_p, t_r = port["t"].numpy(), np.asarray(ref["t"])
    same = tri_p == tri_r
    ties = ~same & (t_p == t_r)
    assert (same | ties).all(), f"{label}: {(~(same | ties)).sum()} apart"
    assert ties.sum() <= max(2, len(tri_p) // 500), label
    hit = same & (tri_r >= 0)
    assert hit.sum() > len(tri_p) // 8, label
    if masked:
        assert np.array_equal(port["mixed"].numpy()[same],
                              np.asarray(ref["mixed"])[same]), label
    for k in ("t", "u", "v"):
        a, b = port[k].numpy()[hit], np.asarray(ref[k])[hit]
        assert np.mean(np.abs(a - b) <= 1e-5) >= 0.99, f"{label} {k}"
        if k == "t":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=label)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=label)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("capped", [False, True])
def test_chunked_closest_vs_glaze_tpu(golden_forest, masked, capped):
    import glaze_tpu.accel as ja
    import glaze_tpu_torch.accel as ta
    from glaze_tpu_torch.accel import bvh as tb

    jf, jpay, tf, tpay, (o, d) = golden_forest
    jtree = jpay if masked else jf
    ttree = tb.bvh_from_np(tpay if masked else tf, "cpu")
    assert isinstance(ttree, tb.ChunkedBVH)
    cap = (np.random.default_rng(44).uniform(2.0, 14.0, len(o))
           .astype(np.float32) if capped else None)
    j3 = tuple(jnp.asarray(o[:, i]) for i in range(3))
    jd = tuple(jnp.asarray(d[:, i]) for i in range(3))
    t3 = tuple(_t(o[:, i]) for i in range(3))
    td = tuple(_t(d[:, i]) for i in range(3))
    jcap = None if cap is None else jnp.asarray(cap)
    tcap = None if cap is None else _t(cap)
    if masked:
        ref = ja.closest_hit_soa_masked_auto(jtree, j3, jd, jcap)
        port = ta.closest_hit_soa_masked_auto(ttree, t3, td, tcap)
    else:
        ref = ja.closest_hit_soa_auto(jtree, j3, jd, jcap)
        port = ta.closest_hit_soa_auto(ttree, t3, td, tcap)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    if cap is not None:
        # glaze_tpu uncaps the chunks after one that missed: cull beyond
        beyond = ref["t"] > cap
        hit = port["tri"].numpy() >= 0
        assert (port["t"].numpy()[hit] < cap[hit]).all()
        ref["t"] = np.where(beyond, np.inf, ref["t"])
        ref["tri"] = np.where(beyond, -1, ref["tri"])
        if masked:
            ref["mixed"] = ref["mixed"] & ~beyond
    _closest_equal(port, ref, f"masked={masked} capped={capped}", masked)


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_any_vs_glaze_tpu(golden_forest, masked):
    import glaze_tpu.accel as ja
    import glaze_tpu_torch.accel as ta
    from glaze_tpu_torch.accel import bvh as tb

    jf, jpay, tf, tpay, (o, d) = golden_forest
    jtree = jpay if masked else jf
    ttree = tb.bvh_from_np(tpay if masked else tf, "cpu")
    rng = np.random.default_rng(46)
    tmax = rng.uniform(0.3, 9.0, len(o)).astype(np.float32)
    active = rng.random(len(o)) < 0.8
    j3 = tuple(jnp.asarray(o[:, i]) for i in range(3))
    jd = tuple(jnp.asarray(d[:, i]) for i in range(3))
    t3 = tuple(_t(o[:, i]) for i in range(3))
    td = tuple(_t(d[:, i]) for i in range(3))
    if masked:
        assert ta.masked_anyhit_ok(ttree) and ja.masked_anyhit_ok(jtree)
        rb, rp = ja.any_hit_soa_masked_auto(
            jtree, j3, jd, jnp.asarray(tmax), active=jnp.asarray(active))
        pb, pp = ta.any_hit_soa_masked_auto(ttree, t3, td, _t(tmax),
                                            active=_t(active))
        assert np.array_equal(pb.numpy(), np.asarray(rb))
        assert np.array_equal(pp.numpy(), np.asarray(rp))
        assert not (pb.numpy() & pp.numpy()).any()
        assert pb.numpy().any() and pp.numpy().any()
        got = pb.numpy() | pp.numpy()
    else:
        ref = ja.any_hit_soa_auto(jtree, j3, jd, jnp.asarray(tmax),
                                  active=jnp.asarray(active))
        port = ta.any_hit_soa_auto(ttree, t3, td, _t(tmax), active=_t(active))
        assert np.array_equal(port.numpy(), np.asarray(ref))
        got = port.numpy()
        assert got.any() and (~got[active]).any()
    assert not got[~active].any()


def test_masked_anyhit_ok_needs_every_chunk(forest):
    import glaze_tpu_torch.accel as ta
    from glaze_tpu_torch.accel import bvh as tb

    _, _, tf, tpay, _, _, _ = forest
    assert not ta.masked_anyhit_ok(tb.bvh_from_np(tf, "cpu"))
    mixed = dict(tpay, chunks=[tf["chunks"][0]] + tpay["chunks"][1:])
    assert not ta.masked_anyhit_ok(tb.bvh_from_np(mixed, "cpu"))
    assert ta.masked_anyhit_ok(tb.bvh_from_np(tpay, "cpu"))


# ---------------------------------------------------------------------------
# whole renders and edits with CHUNK_MAX_TRIS lowered


def _chunks(tree):
    return len(getattr(tree, "chunks", ())) or 1


def _golden_cutout(pkg):
    if pkg == "jax":
        import golden_scenes as gs

        base = gs.MatRowScene
    else:
        import glaze_tpu_torch.scenes as ps

        base = ps.MatRowScene

    class Cutout(base):
        def materials(self):
            mats = super().materials()
            mats[-2].opacity = 1  # texture 1: the golden's checker
            return mats

    return Cutout()


def _render_pair(js, ts, cam, w, h, alpha_rounds):
    """Two launches of both packages' render_steps from the same seeds."""
    from glaze_tpu.render import integrator as ji
    from glaze_tpu_torch.render import integrator as ti

    c2w, s2c = ji.camera_matrices(cam, w, h)
    seeds = np.asarray([3, 5], np.uint32)
    offsets = np.full((2, 2), 0.5, np.float32)
    kw = dict(width=w, height=h, is_persp=True, direct_only=False, steps=2,
              alpha_rounds=alpha_rounds, coherent=1)
    a = ji.render_steps(js, ji.init_state(w, h), jnp.asarray(seeds),
                        jnp.asarray(offsets), jnp.asarray(c2w),
                        jnp.asarray(s2c), **kw)
    b = ti.render_steps(ts, ti.init_state(w, h, "cpu"), seeds, offsets,
                        c2w, s2c, **kw)
    np.testing.assert_array_equal(b.count.numpy(), np.asarray(a.count))
    return (np.stack([np.asarray(x) for x in a.accum], -1),
            torch.stack(b.accum, -1).numpy(), b.count.numpy())


@pytest.mark.parametrize("tree", ["classic", "hybrid"])
def test_tiny_scene_chunked_render_vs_glaze_tpu(tree, monkeypatch):
    """The tiny scene (6 triangles) at a chunk limit of 2: a 4-chunk main
    tree (classic) or any-hit tree (hybrid). 16x16, two launches: count
    exact, accum within 1e-4."""
    from glaze_tpu.scene.flatten import flatten_scene as j_flatten
    from glaze_tpu_torch.accel import ChunkedBVH, FatBVH
    from glaze_tpu_torch.scene import flatten_scene

    monkeypatch.setenv("GLAZE_TREE", tree)
    _lower_chunk_limit(monkeypatch, 2)
    src = _tiny_parsed()
    js, cam, _ = j_flatten(src)
    ts, _, _ = flatten_scene(src, "cpu")
    walked = ts.bvh if tree == "classic" else ts.bvh_any
    assert isinstance(walked, ChunkedBVH) and _chunks(walked) == 4
    assert _chunks(getattr(js, "bvh" if tree == "classic" else "bvh_any")) == 4
    assert isinstance(ts.bvh, FatBVH) == (tree == "hybrid")
    _trees_equal(jax_scene_to_numpy(js), _device_tables(ts))
    a, b, _ = _render_pair(js, ts, cam, 16, 16, 0)
    assert np.isfinite(b).all() and a.max() > 0
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def _trees_equal(a, b):
    """The tree tables of two scenes' fields, bit for bit."""
    _tables_equal({k: v for k, v in a.items() if k.startswith("bvh")},
                  {k: v for k, v in b.items() if k.startswith("bvh")})


def _device_tables(scene):
    from glaze_tpu_torch.scene.flatten import device_scene_to_numpy

    return device_scene_to_numpy(scene)


@pytest.mark.parametrize("tree", ["classic", "hybrid"])
def test_golden_cutout_chunked_render_vs_glaze_tpu(tree, monkeypatch):
    """The golden scene with an opacity map on its checker sphere at a
    chunk limit of 600: classic, a chunked main tree carrying the cell
    masks and chunked opaque and alpha subset trees; hybrid, a fat main
    tree with a chunked any-hit tree. The flatten's tables equal
    glaze_tpu's, and a 32x16 render of two launches agrees: count exact,
    clipped per-pixel MAD below 1e-5, mean within 3%."""
    from glaze_tpu.scene.flatten import flatten_scene as j_flatten
    from glaze_tpu_torch.accel import ChunkedBVH
    from glaze_tpu_torch.render import integrator as ti
    from glaze_tpu_torch.scene import flatten_scene

    monkeypatch.setenv("GLAZE_TREE", tree)
    _lower_chunk_limit(monkeypatch, 600)
    js, cam, _ = j_flatten(_golden_cutout("jax"))
    ts, _, _ = flatten_scene(_golden_cutout("torch"), "cpu")
    if tree == "classic":
        assert isinstance(ts.bvh, ChunkedBVH) and _chunks(ts.bvh) >= 4
        assert ti._full_tree_masked(ts, 1)
        assert _chunks(ts.bvh_opaque) >= 2
    else:
        assert isinstance(ts.bvh_any, ChunkedBVH)
        assert not ti._full_tree_masked(ts, 1)
    _tables_equal(jax_scene_to_numpy(js), _device_tables(ts))
    a, b, count = _render_pair(js, ts, cam, 32, 16, 1)
    assert np.isfinite(b).all()
    n = np.maximum(count, 1.0)[:, None]
    ca, cb = np.clip(a / n, 0.0, 1.0), np.clip(b / n, 0.0, 1.0)
    mad = np.abs(ca - cb).mean()
    print(f"{tree}: per-pixel MAD {mad:.3g}, mean {cb.mean():.5f} vs "
          f"{ca.mean():.5f}")
    assert ca.mean() > 1e-3
    assert abs(cb.mean() - ca.mean()) < 0.03 * ca.mean()
    assert mad < 1e-5


def test_chunked_opacity_edits_match_glaze_tpu_and_a_fresh_renderer(
        monkeypatch):
    """The lace scene (324 triangles) at a chunk limit of 100, flattened
    without its opacity map: add the map, remove it, put it back. After
    each edit the tables (a 4-chunk main tree whose chunks take the
    re-baked masks, the chunked subset trees) equal glaze_tpu's after the
    same edit, and with the map those of a fresh renderer."""
    from glaze_tpu.render.renderer import RayTraceRenderer as JRenderer
    from glaze_tpu_torch.accel import ChunkedBVH
    from glaze_tpu_torch.render import integrator as ti
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    _lower_chunk_limit(monkeypatch, 100)
    kw = dict(width=32, height=16, seed=11, coherent=1)
    j = JRenderer(LaceScene("jax", opacity=False), **kw)
    t = RayTraceRenderer(LaceScene("torch", opacity=False), device="cpu",
                         **kw)
    assert isinstance(t.scene.bvh, ChunkedBVH) and _chunks(t.scene.bvh) == 4
    fresh = _device_tables(RayTraceRenderer(LaceScene("torch"), device="cpu",
                                            **kw).scene)
    for opacity in (True, False, True):
        for r, pkg in ((j, "jax"), (t, "torch")):
            r.update_materials_and_lights(LaceScene(pkg, opacity).materials(),
                                          LaceScene(pkg, opacity).lights())
        tables = _device_tables(t.scene)
        _tables_equal(tables, jax_scene_to_numpy(j.scene))
        if opacity:
            _tables_equal(tables, fresh)
            assert ti._full_tree_masked(t.scene, t._alpha_rounds)
        else:
            assert t.scene.bvh_alpha is None
    img = t.draw(1)
    assert img.shape == (16, 32, 3) and img.mean() > 1


def test_chunked_scene_round_trips(monkeypatch):
    """device_scene_from_numpy / device_scene_to_numpy carry a forest:
    the lace scene's tables survive a round trip bit for bit."""
    from glaze_tpu_torch.scene.flatten import (
        device_scene_from_numpy,
        device_scene_to_numpy,
        flatten_scene_np,
    )

    _lower_chunk_limit(monkeypatch, 100)
    fields, _, _ = flatten_scene_np(LaceScene("torch"))
    assert fields["bvh.chunks"] == 4
    assert "bvh_opaque.chunks" in fields or "bvh_alpha.chunks" in fields
    back = device_scene_to_numpy(device_scene_from_numpy(fields, "cpu"))
    _tables_equal(back, fields)


# ---------------------------------------------------------------------------
# the disk cache


def _count_builds(monkeypatch):
    """Counts the native BVH build's calls."""
    from glaze_tpu_torch import native

    lib = native.get_lib()
    calls = []
    orig = lib.bvh_build_octants

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(lib, "bvh_build_octants", counted)
    return calls


def test_cache_round_trip_bit_exact(tmp_path, monkeypatch):
    from glaze_tpu_torch.accel import bvh as tb

    monkeypatch.setenv("GLAZE_CACHE_DIR", str(tmp_path))
    calls = _count_builds(monkeypatch)
    tri, _ = _random_soup(tb.CACHE_MIN_TRIS + 100, seed=51)
    cold, order_c = tb.build_bvh_np(tri)
    files = os.listdir(tmp_path / "bvh")
    assert len(calls) == 1 and len(files) == 1
    assert files[0].startswith("glaze_torch_bvh_")
    warm, order_w = tb.build_bvh_np(tri)
    assert len(calls) == 1  # read from the cache
    assert order_c.tobytes() == order_w.tobytes()
    for k in cold:
        assert np.asarray(cold[k]).tobytes() == np.asarray(warm[k]).tobytes(), k
    # another soup, another key
    other, _ = _random_soup(tb.CACHE_MIN_TRIS + 100, seed=52)
    tb.build_bvh_np(other)
    assert len(calls) == 2 and len(os.listdir(tmp_path / "bvh")) == 2
    # a damaged file is a miss: rebuilt and rewritten, no error
    path = tmp_path / "bvh" / files[0]
    path.write_bytes(b"not an npz")
    again, _ = tb.build_bvh_np(tri)
    assert len(calls) == 3
    assert np.asarray(again["nodes16"]).tobytes() == np.asarray(
        cold["nodes16"]).tobytes()
    tb.build_bvh_np(tri)
    assert len(calls) == 3


def test_cache_off_and_small_scenes_write_nothing(tmp_path, monkeypatch):
    from glaze_tpu_torch.accel import bvh as tb

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("GLAZE_CACHE_DIR", "0")
    tri, _ = _random_soup(tb.CACHE_MIN_TRIS + 100, seed=53)
    tb.build_bvh_np(tri)
    assert not (tmp_path / "home").exists()
    monkeypatch.setenv("GLAZE_CACHE_DIR", str(tmp_path / "c"))
    tb.build_bvh_np(tri[:tb.CACHE_MIN_TRIS - 1])
    assert not (tmp_path / "c" / "bvh").exists() or not os.listdir(
        tmp_path / "c" / "bvh")
    # unset: the port's own default directory under HOME
    monkeypatch.delenv("GLAZE_CACHE_DIR")
    tb.build_bvh_np(tri)
    files = os.listdir(tmp_path / "home" / ".cache" / "glaze_tpu_torch" / "bvh")
    assert len(files) == 1 and files[0].startswith("glaze_torch_bvh_")


def test_cache_never_reads_glaze_tpu_files(tmp_path, monkeypatch):
    """glaze_tpu's file for the same soup, in the same directory, is not
    read: the port builds and writes its own, and each package then reads
    only its own file."""
    from glaze_tpu.accel import bvh as jb
    from glaze_tpu_torch.accel import bvh as tb

    monkeypatch.setenv("GLAZE_CACHE_DIR", str(tmp_path))
    tri, _ = _random_soup(tb.CACHE_MIN_TRIS + 100, seed=54)
    jb.build_bvh(tri)
    (jfile,) = os.listdir(tmp_path / "bvh")
    calls = _count_builds(monkeypatch)
    fields, _ = tb.build_bvh_np(tri)
    assert len(calls) == 1
    files = sorted(os.listdir(tmp_path / "bvh"))
    assert len(files) == 2 and jfile in files
    # the port's file is not glaze_tpu's name for the soup either
    tfile = [f for f in files if f != jfile][0]
    assert tfile.startswith("glaze_torch_bvh_") and not jfile.startswith(
        "glaze_torch_bvh_")
    jb.build_bvh(tri)
    assert len(os.listdir(tmp_path / "bvh")) == 2
