"""Opacity maps in glaze_tpu_torch against glaze_tpu, on the CPU.

A small lace scene (a 16x10-quad curtain carrying a 64x64 Gray lace map
in front of a wall, on a floor, lit by a point light) goes through both
packages. Its curtain has MIXED triangles and triangles that classify
fully OPAQUE (the solid top band) and fully TRANSPARENT (the cut hem).

- The host tables (cell codes, packed masks, payload-bearing trees, the
  subset trees and their maps, the alpha-test rows, the cluster boxes) are
  bit-exact.
- The plain masked walkers, the port's CUDA kernels' plain versions, hold
  against the JAX walkers: triangle ids and ``mixed`` flags exact except
  exact-t ties, t/u/v within the XLA:CPU bound of ROADMAP F8, and the
  any-hit ``blocked``/``pending`` flags exact.
- trace_alpha in each of its three branches (full masked tree,
  opaque/alpha split, whole-scene re-trace) and _occlusion_sorted agree
  with the JAX package at alpha_rounds 1 and 4, and a whole render agrees
  within the Monte-Carlo bound of tests/test_goldens.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from torch_parity import jax_scene_to_numpy  # noqa: E402

GRID_X, GRID_Y = 16, 10  # curtain quads
TEX = 64  # lace map side, texels


def _lace_tex(n=TEX):
    """Gray lace: a solid top band, round holes on a 4x4 grid and a cut
    hem at the bottom (v near 1)."""
    i = np.arange(n, dtype=np.float32)
    yy, xx = np.meshgrid(i, i, indexing="ij")
    cell = n / 4.0
    cx = (xx % cell) - cell / 2
    cy = (yy % cell) - cell / 2
    holes = ((cx * cx + cy * cy) < (0.3 * cell) ** 2) & (yy > n * 0.3)
    hem = yy > n * 0.75
    return np.where(holes | hem, 0, 255).astype(np.uint8)


class LaceScene:
    """Duck-typed ParsedScene built from one package's core classes."""

    def __init__(self, pkg: str, opacity: bool = True):
        if pkg == "jax":
            import glaze_tpu.core as core
            from glaze_tpu.parser import Meta
        else:
            import glaze_tpu_torch.core as core
            from glaze_tpu_torch.parser import Meta
        self.c = core
        self._meta = Meta(scene_centre=[0, 1.2, 0], scene_radius=5.0,
                          exposure=1.0)
        self._opacity = opacity
        self._verts, self._meshes = [], []
        # floor, back wall: material 2; curtain: material 1
        self._quad([-4, 0, -3], [4, 0, -3], [4, 0, 3], [-4, 0, 3], [0, 1, 0], 2)
        self._quad([-4, 0, -2], [4, 0, -2], [4, 4, -2], [-4, 4, -2], [0, 0, 1], 2)
        self._curtain()

    def _add(self, pos, nrm, uv, idx, material):
        base = len(self._verts)
        for p, t in zip(pos, uv):
            self._verts.append(self.c.Vertex(
                np.asarray(p, np.float32), np.asarray(nrm, np.float32),
                np.asarray(t, np.float32)))
        self._meshes.append(self.c.Mesh(
            len(self._meshes), [base + i for i in idx], material))

    def _quad(self, a, b, c, d, nrm, material, lo=0.0, hi=1.0):
        self._add([a, b, c, d], nrm, [[lo, lo], [hi, lo], [hi, hi], [lo, hi]],
                  [0, 1, 2, 0, 2, 3], material)

    def _curtain(self):
        xs = np.linspace(-1.6, 1.6, GRID_X + 1)
        ys = np.linspace(2.8, 0.2, GRID_Y + 1)  # v grows downwards
        pos, uv, idx = [], [], []
        for j in range(GRID_Y + 1):
            for i in range(GRID_X + 1):
                # a gentle wave in z keeps the sheet from being one plane
                pos.append([xs[i], ys[j], 0.15 * np.sin(1.7 * xs[i])])
                uv.append([i / GRID_X * 2.0, 0.05 + 0.9 * j / GRID_Y])
        for j in range(GRID_Y):
            for i in range(GRID_X):
                a = j * (GRID_X + 1) + i
                b, c, d = a + 1, a + GRID_X + 2, a + GRID_X + 1
                idx += [a, b, c, a, c, d]
        self._add(pos, [0, 0, 1], uv, idx, 1)

    def vertices(self):
        return self._verts

    def meshes(self):
        return self._meshes

    def transforms(self):
        return [self.c.Transform.identity()]

    def instances(self):
        return [self.c.MeshInstance(m.id, 0) for m in self._meshes]

    def cameras(self):
        return [self.c.Camera.Perspective(self.c.PerspectiveCam(
            position=[0.3, 1.5, 4.5], target=[0, 1.4, 0], up=[0, 1, 0]))]

    def textures(self):
        info = self.c.TextureInfo("lace", TEX, TEX, self.c.TextureFormat.Gray)
        return [self.c.Texture.default(), self.c.Texture(info, [_lace_tex()])]

    def materials(self):
        m = self.c.Material
        lam = self.c.MaterialType.LAMBERT
        return [m(name="default"),
                m(name="lace", mtype=lam, opacity=1 if self._opacity else 0),
                m(name="room", mtype=lam)]

    def lights(self):
        return [self.c.Light(ltype=self.c.LightType.OMNI,
                             position=[0.5, 2.5, 3.0], intensity=40.0)]

    def meta(self):
        return self._meta


class StackedQuads:
    """tests/test_render.py test_alpha_stacked_transparent_quads: two
    quads with a fully transparent map in front of a wall. Their uv covers
    the middle of a 16x16 map (a footprint spanning the whole map would
    classify MIXED), so classification drops both and the scene keeps no
    MIXED triangle: the re-trace branch."""

    def __init__(self, pkg: str):
        self.base = LaceScene(pkg)
        b = self.base
        b._verts, b._meshes = [], []
        for z in (4, 3):
            b._quad([-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z], [0, 0, 1],
                    1, lo=0.25, hi=0.75)
        b._quad([-5, -5, 2.5], [5, -5, 2.5], [5, 5, 2.5], [-5, 5, 2.5],
                [0, 0, 1], 2)

    def __getattr__(self, name):
        return getattr(self.base, name)

    def textures(self):
        c = self.base.c
        info = c.TextureInfo("op", 16, 16, c.TextureFormat.Gray)
        return [c.Texture.default(),
                c.Texture(info, [np.zeros((16, 16), np.uint8)])]


@pytest.fixture(scope="module")
def lace():
    """(JAX scene, port scene, JAX fields as NumPy, port host fields)."""
    from glaze_tpu.scene.flatten import flatten_scene
    from glaze_tpu_torch.scene.flatten import (
        device_scene_from_numpy,
        flatten_scene_np,
    )

    js, _, _ = flatten_scene(LaceScene("jax"))
    tf, _, _ = flatten_scene_np(LaceScene("torch"))
    return js, device_scene_from_numpy(tf, "cpu"), jax_scene_to_numpy(js), tf


@pytest.fixture(scope="module")
def branches(lace):
    """One scene per trace_alpha branch, as (JAX scene, port scene):
    the full masked tree (the lace scene), the opaque/alpha split (the
    lace scene flattened by glaze_tpu without masks and carried across)
    and the whole-scene re-trace (the stacked quads)."""
    from glaze_tpu.scene.flatten import flatten_scene as j_flatten
    from glaze_tpu_torch.scene.flatten import (
        device_scene_from_numpy,
        flatten_scene,
    )

    mp = pytest.MonkeyPatch()
    mp.setenv("GLAZE_ALPHA_MASK", "0")
    try:
        js_split, _, _ = j_flatten(LaceScene("jax"))
    finally:
        mp.undo()
    js_re, _, _ = j_flatten(StackedQuads("jax"))
    ts_re, _, _ = flatten_scene(StackedQuads("torch"), "cpu")
    return {
        "full": (lace[0], lace[1]),
        "split": (js_split, device_scene_from_numpy(
            jax_scene_to_numpy(js_split), "cpu")),
        "retrace": (js_re, ts_re),
    }


def _curtain_tris(pkg):
    """(tri_uv (N, 3, 2), curtain triangle ids) of the lace scene."""
    scene = LaceScene(pkg)
    verts = scene.vertices()
    uv = np.stack([v.vt for v in verts]).astype(np.float32)
    idx = np.concatenate([np.asarray(m.indices, np.int64).reshape(-1, 3)
                          for m in scene.meshes()])
    first = sum(len(m.indices) for m in scene.meshes()[:-1]) // 3
    return uv[idx], np.arange(first, idx.shape[0]), scene.textures()[1]


# ---------------------------------------------------------------------------
# host tables


def test_pack_and_decode_masks_match():
    from glaze_tpu.accel import bvh as jb
    from glaze_tpu_torch.accel import bvh as tb

    rng = np.random.default_rng(20)
    codes = rng.integers(0, 3, size=(37, 64)).astype(np.int8)
    pj, pt = jb.pack_alpha_masks(codes), tb.pack_alpha_masks(codes)
    assert pt.dtype == np.int32 and np.array_equal(pj, pt)
    assert (tb.TRI_PAYLOAD_BASE, tb.ALPHA_MASK_GRID, tb.ALPHA_MASK_WORDS) == (
        jb.TRI_PAYLOAD_BASE, jb.ALPHA_MASK_GRID, jb.ALPHA_MASK_WORDS)
    # decode at random barycentrics, cell edges included
    u = rng.uniform(0, 1, (37, 50)).astype(np.float32)
    v = (rng.uniform(0, 1, (37, 50)) * (1 - u)).astype(np.float32)
    u[:, :8] = np.arange(8) / 8.0
    rows = np.zeros((37, 50, 13), np.float32)
    rows[..., 9:13] = pt.view(np.float32)[:, None, :]
    want = np.asarray(jb._mask_bits(jnp.asarray(rows), jnp.asarray(u),
                                    jnp.asarray(v)))
    words = torch.from_numpy(np.broadcast_to(pt[:, None, :], (37, 50, 4)).copy())
    got = tb._mask_bits(words, torch.from_numpy(u), torch.from_numpy(v),
                        torch.ones(u.shape, dtype=torch.bool))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, codes[np.arange(37)[:, None],
                                      np.minimum((v * 8).astype(int), 7) * 8
                                      + np.minimum((u * 8).astype(int), 7)])


def test_classification_codes_match():
    from glaze_tpu.scene import flatten as jfl
    from glaze_tpu_torch.scene import flatten as tfl

    uv_j, sel, tex_j = _curtain_tris("jax")
    uv_t, _, tex_t = _curtain_tris("torch")
    tri_j = jfl._classify_alpha_tris(uv_j, sel, tex_j)
    tri_t = tfl._classify_alpha_tris(uv_t, sel, tex_t)
    assert np.array_equal(tri_j, tri_t)
    assert set(np.unique(tri_t)) == {0, 1, 2}  # mixed, opaque, transparent
    cell_j = jfl._classify_alpha_cells(uv_j, sel, tex_j)
    cell_t = tfl._classify_alpha_cells(uv_t, sel, tex_t)
    assert cell_t.shape == (sel.size, 64) and np.array_equal(cell_j, cell_t)
    assert set(np.unique(cell_t[tri_t == 0])) == {0, 1, 2}


def test_attach_tri_payload_matches():
    from glaze_tpu.accel import bvh as jb
    from glaze_tpu_torch.accel import bvh as tb

    rng = np.random.default_rng(21)
    tris = rng.uniform(-1, 1, (150, 3, 3)).astype(np.float32)
    jt, _ = jb.build_bvh(tris)
    tf, _ = tb.build_bvh_np(tris)
    payload = rng.integers(-2**31, 2**31, (tf["tri"].shape[0], 4),
                           dtype=np.int64).astype(np.int32)
    ja = jb.attach_tri_payload(jt, payload)
    ta = tb.attach_tri_payload(tf, payload)
    for k in ("tri", "tri8", "nodes", "nodes16"):
        assert np.array_equal(np.asarray(getattr(ja, k)).view(np.int32),
                              ta[k].view(np.int32)), k
    assert ta["tri"].shape[1] == 13
    assert np.array_equal(ta["tri"][:, 9:].view(np.int32), payload)
    assert tb.has_payload(tb.bvh_from_np(ta, "cpu"))
    assert not tb.has_payload(tb.bvh_from_np(tf, "cpu"))


OPACITY_FIELDS = ("bvh.tri", "bvh.tri8", "bvh_opaque.nodes", "bvh_opaque.tri",
                  "bvh_opaque.nodes16", "bvh_opaque.tri8", "bvh_opaque_map",
                  "bvh_alpha.nodes", "bvh_alpha.tri", "bvh_alpha.nodes16",
                  "bvh_alpha.tri8", "bvh_alpha_map", "alpha_attr",
                  "alpha_attr_full", "alpha_boxes")


def test_flatten_opacity_fields_bit_exact(lace):
    _, _, jf, tf = lace
    assert sorted(jf) == sorted(tf)
    for key in OPACITY_FIELDS:
        a, b = np.asarray(jf[key]), np.asarray(tf[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        assert a.tobytes() == b.tobytes(), key
    for key in sorted(jf):
        a, b = np.asarray(jf[key]), np.asarray(tf[key])
        assert a.tobytes() == b.tobytes(), key
    assert jf["bvh_alpha.n_tris"] == tf["bvh_alpha.n_tris"] > 0
    assert jf["bvh_opaque.n_tris"] == tf["bvh_opaque.n_tris"] > 0


@pytest.mark.parametrize("masks", ["on", "off"])
def test_subset_trees_cross_table_by_table(masks, monkeypatch):
    """device_scene_from_numpy / device_scene_to_numpy carry a JAX scene's
    subset trees bitwise, with and without the baked masks."""
    from glaze_tpu.scene.flatten import flatten_scene
    from glaze_tpu_torch.scene.flatten import (
        device_scene_from_numpy,
        device_scene_to_numpy,
    )

    if masks == "off":
        monkeypatch.setenv("GLAZE_ALPHA_MASK", "0")
    js, _, _ = flatten_scene(LaceScene("jax"))
    fields = jax_scene_to_numpy(js)
    scene = device_scene_from_numpy(fields, "cpu")
    back = device_scene_to_numpy(scene)
    assert sorted(back) == sorted(fields)
    for key, want in fields.items():
        got = back[key]
        if isinstance(want, int):
            assert got == want, key
        else:
            assert np.asarray(want).tobytes() == got.tobytes(), key
    assert scene.bvh_alpha is not None and scene.bvh_opaque is not None
    assert scene.bvh.tri.shape[1] == (13 if masks == "on" else 9)
    assert scene.bvh_alpha.tri.shape[1] == (13 if masks == "on" else 9)
    assert (scene.alpha_attr_full is None) == (masks == "off")


def test_opaque_scene_has_no_split():
    from glaze_tpu_torch.scene.flatten import flatten_scene_np

    tf, _, _ = flatten_scene_np(LaceScene("torch", opacity=False))
    assert tf["bvh.tri"].shape[1] == 9
    assert not any(k.startswith(("bvh_opaque", "bvh_alpha", "alpha_"))
                   for k in tf)


# ---------------------------------------------------------------------------
# plain masked walkers


def _rays(n=3000, seed=22):
    """Rays through the curtain from the camera side, plus random rays
    from inside the room; unit directions."""
    rng = np.random.default_rng(seed)
    k = n // 2
    o1 = np.stack([rng.uniform(-2, 2, k), rng.uniform(0.2, 2.8, k),
                   np.full(k, 4.0)], 1)
    tgt = np.stack([rng.uniform(-1.8, 1.8, k), rng.uniform(0.0, 3.0, k),
                    rng.uniform(-0.3, 0.3, k)], 1)
    d1 = tgt - o1
    o2 = rng.uniform([-3.5, 0.1, -1.8], [3.5, 3.5, 2.5], (n - k, 3))
    d2 = rng.normal(size=(n - k, 3))
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _compare_closest(port, ref, label):
    """tri and mixed exact except exact-t ties (ROADMAP F3); t/u/v within
    the XLA:CPU rounding bound of ROADMAP F8: 99% of hits within 1e-5,
    all within 1e-4 (t: 1e-5 relative)."""
    tri_p, tri_r = port["tri"].numpy(), np.asarray(ref["tri"])
    t_p, t_r = port["t"].numpy(), np.asarray(ref["t"])
    same = tri_p == tri_r
    ties = ~same & (t_p == t_r)
    assert (same | ties).all(), f"{label}: {(~(same | ties)).sum()} mismatches"
    assert ties.sum() <= max(2, len(tri_p) // 500), label
    mix_p, mix_r = port["mixed"].numpy(), np.asarray(ref["mixed"])
    assert np.array_equal(mix_p[same], mix_r[same]), label
    hit = same & (tri_r >= 0)
    assert hit.sum() > len(tri_p) // 8, label
    for k in ("t", "u", "v"):
        a, b = port[k].numpy()[hit], np.asarray(ref[k])[hit]
        assert np.mean(np.abs(a - b) <= 1e-5) >= 0.99, f"{label} {k}"
        if k == "t":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=label)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=label)
    return hit, mix_p


@pytest.mark.parametrize("tree", ["bvh", "bvh_alpha"])
@pytest.mark.parametrize("capped", [False, True])
def test_closest_hit_masked_vs_jax(lace, tree, capped):
    from glaze_tpu.accel.bvh import closest_hit_masked as j_closest
    from glaze_tpu_torch.accel import bvh as B

    js, ts, _, _ = lace
    o, d = _rays()
    tmax = (np.random.default_rng(23).uniform(0.5, 9.0, len(o))
            .astype(np.float32) if capped else None)
    ref = j_closest(getattr(js, tree), jnp.asarray(o), jnp.asarray(d),
                    None if tmax is None else jnp.asarray(tmax))
    stats = B.WalkStats()
    port = B.closest_hit_masked(getattr(ts, tree), torch.from_numpy(o),
                                torch.from_numpy(d),
                                None if tmax is None else torch.from_numpy(tmax),
                                stats=stats)
    hit, mix = _compare_closest(port, ref, f"{tree} capped={capped}")
    # both kinds of accepted hit occur
    assert mix[hit].any() and (~mix[hit]).any()
    assert 0 < stats.mask_tests <= stats.tri_tests
    if tree == "bvh":
        # the masks skip hits: the unmasked walk stops earlier on some rays
        plain = B.closest_hit(ts.bvh, torch.from_numpy(o), torch.from_numpy(d),
                              None if tmax is None else torch.from_numpy(tmax))
        assert (plain["t"].numpy() < port["t"].numpy()).any()


def test_any_hit_masked_vs_jax(lace):
    from glaze_tpu.accel.bvh import any_hit_masked as j_any
    from glaze_tpu_torch.accel import bvh as B

    js, ts, _, _ = lace
    o, d = _rays(seed=24)
    rng = np.random.default_rng(25)
    tmax = rng.uniform(0.3, 9.0, len(o)).astype(np.float32)
    active = rng.uniform(size=len(o)) > 0.2
    jb_, jp = j_any(js.bvh, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                    active=jnp.asarray(active))
    stats = B.WalkStats()
    blk, pend = B.any_hit_masked(ts.bvh, torch.from_numpy(o),
                                 torch.from_numpy(d), torch.from_numpy(tmax),
                                 active=torch.from_numpy(active), stats=stats)
    blk, pend = blk.numpy(), pend.numpy()
    assert np.array_equal(blk, np.asarray(jb_))
    assert np.array_equal(pend, np.asarray(jp))
    assert blk.any() and pend.any() and (~blk & ~pend & active).any()
    assert not (blk & pend).any()
    assert not (blk | pend)[~active].any()
    assert stats.mask_tests > 0


def test_masked_dispatchers_without_payload(lace):
    """A payload-free tree (the opaque subset tree) through the masked
    dispatchers: the unmasked closest hit with mixed = tri >= 0, and any
    hit as (zeros, hit), exactly as glaze_tpu's dispatchers give."""
    import glaze_tpu.accel as ja
    import glaze_tpu_torch.accel as ta

    js, ts, _, _ = lace
    o, d = _rays(600, seed=26)
    tmax = np.full(len(o), 6.0, np.float32)
    o3j = tuple(jnp.asarray(o[:, i]) for i in range(3))
    d3j = tuple(jnp.asarray(d[:, i]) for i in range(3))
    o3t = tuple(torch.from_numpy(o[:, i].copy()) for i in range(3))
    d3t = tuple(torch.from_numpy(d[:, i].copy()) for i in range(3))
    assert not ta.masked_anyhit_ok(ts.bvh_opaque)
    assert ta.masked_anyhit_ok(ts.bvh) and ta.masked_anyhit_ok(ts.bvh_alpha)
    assert ja.masked_anyhit_ok(js.bvh_opaque) == ta.masked_anyhit_ok(ts.bvh_opaque)
    ref = ja.closest_hit_soa_masked_auto(js.bvh_opaque, o3j, d3j)
    got = ta.closest_hit_soa_masked_auto(ts.bvh_opaque, o3t, d3t)
    _compare_closest(got, ref, "payload-free closest")
    assert np.array_equal(got["mixed"].numpy(), got["tri"].numpy() >= 0)
    bj, pj = ja.any_hit_soa_masked_auto(js.bvh_opaque, o3j, d3j,
                                        jnp.asarray(tmax))
    bt, pt = ta.any_hit_soa_masked_auto(ts.bvh_opaque, o3t, d3t,
                                        torch.from_numpy(tmax))
    assert not bt.any() and np.array_equal(bt.numpy(), np.asarray(bj))
    assert pt.any() and np.array_equal(pt.numpy(), np.asarray(pj))


def test_masked_kernels_refuse_cpu_and_missing_nvcc(lace, monkeypatch):
    """No fallback: the masked kernel wrappers raise for CPU tensors, and
    for a tree without the payload; a build without nvcc raises."""
    from glaze_tpu_torch.accel import traverse_cuda as tc

    _, ts, _, _ = lace
    o3 = tuple(torch.zeros(4) for _ in range(3))
    d3 = (torch.zeros(4), torch.zeros(4), -torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        tc.closest_hit_soa_masked(ts.bvh, o3, d3)
    with pytest.raises(ValueError, match="CUDA"):
        tc.any_hit_soa_masked(ts.bvh, o3, d3, torch.ones(4))
    with pytest.raises(ValueError, match="payload"):
        tc.any_hit_soa_masked(ts.bvh_opaque, o3, d3, torch.ones(4))
    assert tc.closest_hit_soa_masked.launches == 0
    assert tc.any_hit_soa_masked.launches == 0
    from glaze_tpu_torch import cuda_build

    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        tc.build()


# ---------------------------------------------------------------------------
# the integrator's alpha machinery


def _trace_inputs(n=512, seed=27):
    o, d = _rays(n, seed)
    rng = np.random.default_rng(seed + 1)
    tmax = rng.uniform(1.0, 9.0, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.2
    o3j = tuple(jnp.asarray(o[:, i]) for i in range(3))
    d3j = tuple(jnp.asarray(d[:, i]) for i in range(3))
    o3t = tuple(torch.from_numpy(o[:, i].copy()) for i in range(3))
    d3t = tuple(torch.from_numpy(d[:, i].copy()) for i in range(3))
    return o3j, d3j, o3t, d3t, tmax, active


def _compare_hits(port, ref, label):
    tri_p, tri_r = port["tri"].numpy(), np.asarray(ref["tri"])
    t_p, t_r = port["t"].numpy(), np.asarray(ref["t"])
    same = tri_p == tri_r
    ties = ~same & np.isclose(t_p, t_r, rtol=1e-5)
    assert (same | ties).all(), f"{label}: {(~(same | ties)).sum()} mismatches"
    assert ties.sum() <= 2, label
    hit = same & (tri_r >= 0)
    assert hit.any(), label
    np.testing.assert_allclose(t_p[hit], t_r[hit], rtol=1e-4, err_msg=label)
    assert np.isinf(t_p[tri_p < 0]).all(), label


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("branch", ["full", "split", "retrace"])
def test_trace_alpha_branches_vs_jax(branches, branch, rounds):
    from glaze_tpu.render import integrator as ji
    from glaze_tpu_torch.render import integrator as ti

    js, ts = branches[branch]
    assert ti._full_tree_masked(ts, rounds) == (branch == "full")
    assert (ts.bvh_alpha is None) == (branch == "retrace")
    o3j, d3j, o3t, d3t, tmax, _ = _trace_inputs()
    # uncapped through trace_alpha, capped through the sorted form
    ref = ji.trace_alpha(js, o3j, d3j, alpha_rounds=rounds)
    got = ti.trace_alpha(ts, o3t, d3t, alpha_rounds=rounds)
    _compare_hits(got, ref, f"{branch} r{rounds}")
    ref = ji.trace_alpha_sorted(js, o3j, d3j, jnp.asarray(tmax),
                                alpha_rounds=rounds)
    got = ti.trace_alpha_sorted(ts, o3t, d3t, torch.from_numpy(tmax),
                                alpha_rounds=rounds)
    _compare_hits(got, ref, f"{branch} sorted capped r{rounds}")


def test_stacked_transparent_quads(branches):
    """tests/test_render.py's stacked-quads case on the port: a ray
    through two fully transparent quads reaches the wall behind them;
    caps apply to the first trace and the re-traces."""
    from glaze_tpu_torch.render import integrator as ti

    _, ts = branches["retrace"]
    o = (torch.tensor([0.1, 0.1]), torch.tensor([0.1, 0.1]),
         torch.tensor([6.0, 6.0]))
    d = (torch.zeros(2), torch.zeros(2), torch.tensor([-1.0, -1.0]))
    hit = ti.trace_alpha(ts, o, d, alpha_rounds=4)
    np.testing.assert_allclose(hit["t"].numpy(), 3.5, atol=1e-3)
    for rounds in (0, 4):
        capped = ti.trace_alpha(ts, o, d, t_max=1.0, alpha_rounds=rounds)
        assert np.isinf(capped["t"].numpy()).all()
        assert (capped["tri"].numpy() == -1).all()
    mid = ti.trace_alpha(ts, o, d, t_max=3.2, alpha_rounds=4)
    assert np.isinf(mid["t"].numpy()).all()


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("branch", ["full", "split", "retrace"])
def test_occlusion_sorted_vs_jax(branches, branch, rounds):
    from glaze_tpu.render import integrator as ji
    from glaze_tpu_torch.render import integrator as ti

    js, ts = branches[branch]
    o3j, d3j, o3t, d3t, tmax, active = _trace_inputs(seed=29)
    ref = np.asarray(ji._occlusion_sorted(js, o3j, d3j, jnp.asarray(tmax),
                                          jnp.asarray(active), rounds))
    got = ti._occlusion_sorted(ts, o3t, d3t, torch.from_numpy(tmax),
                               torch.from_numpy(active), rounds).numpy()
    assert np.array_equal(got, ref), f"{(got != ref).sum()} lanes differ"
    assert got.any() and (~got & active).any()
    assert not got[~active].any()


# ---------------------------------------------------------------------------
# renderer and CLI


RW, RH, RSPP, RSEED = 32, 16, 2, 31


def test_render_matches_jax():
    """A whole PATH_TRACE render of the lace scene, 32x16, 2 spp, coherent
    1, same seed: count exact, the image mean within the Monte-Carlo
    bound of tests/test_goldens.py (3%), and the clipped per-pixel MAD
    below 1e-5: same seeds and same tables give the same paths, so the
    MAD (5.7e-9 here) measures only float rounding, and a wrong opacity
    decision on the curtain's pixels would exceed it."""
    from glaze_tpu.render.renderer import RayTraceRenderer as JRenderer
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    jr = JRenderer(LaceScene("jax"), width=RW, height=RH, seed=RSEED,
                   coherent=1)
    assert jr._alpha_rounds == 1
    jr.draw(RSPP, return_image=False)
    tr = RayTraceRenderer(LaceScene("torch"), width=RW, height=RH, seed=RSEED,
                          coherent=1, device="cpu")
    assert tr._alpha_rounds == 1
    tr.draw(RSPP, return_image=False)
    cj = np.asarray(jr._state.count)
    ct = tr._state.count.numpy()
    np.testing.assert_array_equal(ct, cj)
    aj = np.stack([np.asarray(c) for c in jr._state.accum], -1)
    at = torch.stack(tr._state.accum, -1).numpy()
    assert np.isfinite(at).all()
    ca = np.clip(at / np.maximum(ct, 1.0)[:, None], 0.0, 1.0)
    cg = np.clip(aj / np.maximum(cj, 1.0)[:, None], 0.0, 1.0)
    mad = np.abs(ca - cg).mean()
    print(f"lace render: per-pixel MAD {mad:.3g}, image mean "
          f"{ca.mean():.5f} vs {cg.mean():.5f}")
    assert cg.mean() > 1e-3
    assert abs(ca.mean() - cg.mean()) < 0.03 * cg.mean()
    assert mad < 1e-5


def test_renderer_alpha_rounds():
    from glaze_tpu_torch.render.renderer import RayTraceRenderer
    from glaze_tpu_torch.scene import flatten_scene

    assert RayTraceRenderer(LaceScene("torch"), width=8, height=8,
                            device="cpu")._alpha_rounds == 1
    assert RayTraceRenderer(LaceScene("torch", opacity=False), width=8,
                            height=8, device="cpu")._alpha_rounds == 0
    # a DeviceScene without host data reads the material table
    scene, _, _ = flatten_scene(LaceScene("torch"), "cpu")
    assert RayTraceRenderer(scene, width=8, height=8)._alpha_rounds == 1


def test_cli_renders_opacity_scene(tmp_path):
    from PIL import Image

    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch import cli

    path = tmp_path / "lace.glaze"
    ps.write_glaze(LaceScene("torch"), str(path))
    out = tmp_path / "lace.png"
    code = cli.main([str(path), str(out), "--res", "24x12", "--spp", "1",
                     "--seed", "3", "--device", "cpu"])
    assert code == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (12, 24, 3) and img.mean() > 5
