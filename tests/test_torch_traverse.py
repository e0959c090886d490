"""The traversal module (the CUDA kernels' home) against glaze_tpu.

On the CPU the port's walkers are the kernels' plain versions; here they
are held against both JAX forms on identical tables: the XLA walker
(glaze_tpu/accel/bvh.py) and the Pallas kernels in interpret mode.
Triangle ids must match exactly except where two triangles tie exactly
on t (the walk order decides those; counted, see ROADMAP F3); t/u/v
agree within 1e-6 and any-hit flags exactly. The kernels themselves run
only on a card: test_kernels_match_plain_on_cuda, and chip_smoke.py. The
masked walkers are held against glaze_tpu in tests/test_torch_alpha.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from torch_parity import golden_scenes_pair, port_scene_from_jax  # noqa: E402

R_RANDOM = 4096


@pytest.fixture(scope="module")
def scenes():
    js, cam = golden_scenes_pair()
    return js, port_scene_from_jax(js, "cpu"), cam


def _rays(cam):
    """Camera rays of the golden view (64x32) plus random rays from inside
    the scene's box; unit directions."""
    from glaze_tpu_torch.render import integrator as integ

    w, h = 64, 32
    c2w, s2c = integ.camera_matrices(cam, w, h)
    px, py = integ.pixel_coords(w, h, "cpu")
    ndc_x = -1.0 + 2.0 * (px + 0.5) / w
    ndc_y = -1.0 + 2.0 * (py + 0.5) / h
    o3, d3 = integ.camera_rays(ndc_x, ndc_y, c2w, s2c, True)
    rng = np.random.default_rng(30)
    o = rng.uniform([-7.0, 0.05, -3.5], [7.0, 6.0, 3.5], (R_RANDOM, 3))
    d = rng.normal(size=(R_RANDOM, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.concatenate([torch.stack(o3, -1).numpy(), o]).astype(np.float32)
    d = np.concatenate([torch.stack(d3, -1).numpy(), d]).astype(np.float32)
    return o, d


def _compare_closest(port, ref, label):
    tri_p, tri_r = port["tri"].numpy(), np.asarray(ref["tri"])
    t_p, t_r = port["t"].numpy(), np.asarray(ref["t"])
    same = tri_p == tri_r
    ties = ~same & (t_p == t_r)
    assert (same | ties).all(), f"{label}: {(~(same | ties)).sum()} mismatches"
    print(f"{label}: {ties.sum()} exact-t ties excluded of {len(tri_p)} rays")
    assert ties.sum() <= max(2, len(tri_p) // 500)
    hit = same & (tri_r >= 0)
    assert hit.sum() > len(tri_p) // 8
    assert np.isinf(t_p[~(tri_p >= 0)]).all()
    for k in ("t", "u", "v"):
        a, b = port[k].numpy()[hit], np.asarray(ref[k])[hit]
        # XLA:CPU rounds Moller-Trumbore's products and sums differently
        # from the port (whose CUDA kernels, built with --fmad=false,
        # match its plain walker bit for bit). The cross products cancel,
        # so t moves by up to ~25 ulp and u/v by up to ~3.5e-5 absolute
        # (measured on these rays); the median difference is 0-1 ulp.
        # Bound: >= 99% of hits within 1e-5, all within 1e-4 absolute
        # (t: 1e-5 relative).
        assert np.mean(np.abs(a - b) <= 1e-5) >= 0.99, f"{label} {k}"
        if k == "t":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=f"{label} t")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                       err_msg=f"{label} {k}")


@pytest.mark.parametrize("capped", [False, True])
def test_closest_vs_xla_walker(scenes, capped):
    from glaze_tpu.accel import closest_hit as j_closest
    from glaze_tpu_torch.accel import bvh as B

    js, ts, cam = scenes
    o, d = _rays(cam)
    tmax = None
    if capped:
        tmax = np.random.default_rng(31).uniform(0.5, 12.0, len(o)).astype(np.float32)
    ref = j_closest(js.bvh, jnp.asarray(o), jnp.asarray(d),
                    None if tmax is None else jnp.asarray(tmax))
    port = B.closest_hit(ts.bvh, torch.from_numpy(o), torch.from_numpy(d),
                         None if tmax is None else torch.from_numpy(tmax))
    _compare_closest(port, ref, f"xla capped={capped}")


def test_closest_vs_pallas_interpret(scenes):
    from glaze_tpu.accel.traverse_pallas import closest_hit_soa
    from glaze_tpu_torch.accel import closest_hit_soa_auto

    js, ts, cam = scenes
    o, d = _rays(cam)
    ref = closest_hit_soa(js.bvh, tuple(jnp.asarray(o[:, i]) for i in range(3)),
                          tuple(jnp.asarray(d[:, i]) for i in range(3)),
                          interpret=True)
    port = closest_hit_soa_auto(ts.bvh,
                                tuple(torch.from_numpy(o[:, i].copy()) for i in range(3)),
                                tuple(torch.from_numpy(d[:, i].copy()) for i in range(3)))
    _compare_closest(port, ref, "pallas interpret")


def _shadow_inputs(cam):
    o, d = _rays(cam)
    rng = np.random.default_rng(32)
    tmax = rng.uniform(0.2, 15.0, len(o)).astype(np.float32)
    active = rng.uniform(size=len(o)) > 0.25
    return o, d, tmax, active


def test_any_hit_vs_xla_walker(scenes):
    from glaze_tpu.accel import any_hit as j_any
    from glaze_tpu_torch.accel import bvh as B

    js, ts, cam = scenes
    o, d, tmax, active = _shadow_inputs(cam)
    ref = np.asarray(j_any(js.bvh, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tmax), active=jnp.asarray(active)))
    port = B.any_hit(ts.bvh, torch.from_numpy(o), torch.from_numpy(d),
                     torch.from_numpy(tmax), active=torch.from_numpy(active))
    assert np.array_equal(port.numpy(), ref)
    assert 0 < ref.sum() < active.sum()
    assert not port.numpy()[~active].any()


def test_any_hit_vs_pallas_interpret(scenes):
    from glaze_tpu.accel.traverse_pallas import any_hit_soa
    from glaze_tpu_torch.accel import any_hit_soa_auto

    js, ts, cam = scenes
    o, d, tmax, active = _shadow_inputs(cam)
    ref = np.asarray(any_hit_soa(
        js.bvh, tuple(jnp.asarray(o[:, i]) for i in range(3)),
        tuple(jnp.asarray(d[:, i]) for i in range(3)), jnp.asarray(tmax),
        active=jnp.asarray(active), interpret=True))
    port = any_hit_soa_auto(
        ts.bvh, tuple(torch.from_numpy(o[:, i].copy()) for i in range(3)),
        tuple(torch.from_numpy(d[:, i].copy()) for i in range(3)),
        torch.from_numpy(tmax), active=torch.from_numpy(active))
    assert np.array_equal(port.numpy(), ref)


def test_empty_scene_reports_misses():
    from glaze_tpu.accel import any_hit as j_any
    from glaze_tpu.accel import build_bvh as j_build
    from glaze_tpu.accel import closest_hit as j_closest
    from glaze_tpu_torch.accel import any_hit, build_bvh, closest_hit

    empty = np.zeros((0, 3, 3), np.float32)
    jb, _ = j_build(empty)
    tb, order = build_bvh(empty, "cpu")
    assert tb.n_tris == 0 and order.size == 0
    assert np.array_equal(np.asarray(jb.nodes16).view(np.int32),
                          tb.nodes16.numpy().view(np.int32))
    rng = np.random.default_rng(33)
    o = rng.normal(size=(64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    port = closest_hit(tb, torch.from_numpy(o), torch.from_numpy(d))
    ref = j_closest(jb, jnp.asarray(o), jnp.asarray(d))
    assert (port["tri"].numpy() == -1).all() and np.isinf(port["t"].numpy()).all()
    assert np.array_equal(port["tri"].numpy(), np.asarray(ref["tri"]))
    hit = any_hit(tb, torch.from_numpy(o), torch.from_numpy(d), torch.full((64,), 1e9))
    assert not hit.any()
    assert not np.asarray(j_any(jb, jnp.asarray(o), jnp.asarray(d),
                                jnp.full((64,), 1e9))).any()


def test_tiny_direction_rule():
    """|d| < 1e-20 -> 1e20*sign(d), exact 0 -> +1e20 (the XLA walker's rule,
    which the kernels share)."""
    from glaze_tpu_torch.accel.bvh import safe_inv

    d = torch.tensor([0.0, -0.0, 1e-25, -1e-25, 2.0, -4.0])
    assert safe_inv(d).tolist() == pytest.approx(
        [1e20, 1e20, 1e20, -1e20, 0.5, -0.25])


def test_walk_stats_count_work(scenes):
    from glaze_tpu_torch.accel import bvh as B

    _, ts, cam = scenes
    o, d = _rays(cam)
    stats = B.WalkStats()
    B.closest_hit(ts.bvh, torch.from_numpy(o), torch.from_numpy(d), stats=stats)
    assert stats.node_visits >= len(o)
    assert 0 < stats.tri_tests <= stats.node_visits * B.LEAF_SIZE


def _random_payload_tree(ts, device):
    """The golden tree with random cell codes (0/1/2) in its payload."""
    from glaze_tpu_torch.accel import bvh as B

    rng = np.random.default_rng(34)
    fields = {k: getattr(ts.bvh, k) for k in ("nodes", "tri", "nodes16",
                                               "tri8", "n_nodes", "n_tris")}
    fields = {k: v if isinstance(v, int) else v.numpy() for k, v in fields.items()}
    codes = rng.integers(0, 3, (fields["tri"].shape[0], 64)).astype(np.int8)
    return B.bvh_from_np(B.attach_tri_payload(
        fields, B.pack_alpha_masks(codes)), device)


@pytest.mark.parametrize("masked", [False, True])
def test_walk_reads_own_octant(scenes, masked):
    """The plain walkers walk each ray's own octant slab of nodes16 (the
    kernels' order), and count the distinct node rows, triangles and
    payload words they read."""
    from glaze_tpu_torch.accel import bvh as B

    _, ts, cam = scenes
    bvh = _random_payload_tree(ts, "cpu") if masked else ts.bvh
    closest = B.closest_hit_masked if masked else B.closest_hit
    anyhit = B.any_hit_masked if masked else B.any_hit
    o, d, tmax, active = _shadow_inputs(cam)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    tm, act = torch.from_numpy(tmax), torch.from_numpy(active)
    slab = (bvh.nodes16.shape[0] // 8) * 16
    for walk in (lambda st: closest(bvh, o, d, tm, stats=st),
                 lambda st: anyhit(bvh, o, d, tm, active=act, stats=st)):
        st = B.WalkStats()
        walk(st)
        assert 0 < st.distinct("nodes") <= st.node_visits
        assert 0 < st.distinct("tris") <= st.tri_tests
        assert (0 < st.distinct("mask_words") <= st.mask_tests) == masked
        # rays of all 8 direction octants, each read in its own slab
        seen = torch.nonzero(st._seen["nodes"]).flatten() // slab
        assert torch.unique(seen).numel() == 8


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda(scenes):
    """Needs a CUDA card (skips here): the four kernels (closest hit and
    any hit, unmasked and masked) against their plain versions on the same
    CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.accel import traverse_cuda as tc

    _, ts, cam = scenes
    bvh = ts.bvh.to("cuda")
    o, d, tmax, active = _shadow_inputs(cam)
    o_t, d_t = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    o3 = tuple(o_t[:, i].contiguous() for i in range(3))
    d3 = tuple(d_t[:, i].contiguous() for i in range(3))
    k = tc.closest_hit_soa(bvh, o3, d3)
    p = B.closest_hit(bvh, o_t, d_t)
    same = k["tri"] == p["tri"]
    assert bool((same | (k["t"] == p["t"])).all())
    for key in ("t", "u", "v"):
        assert torch.equal(k[key][same], p[key][same])
    tm, act = torch.from_numpy(tmax).cuda(), torch.from_numpy(active).cuda()
    assert torch.equal(tc.any_hit_soa(bvh, o3, d3, tm, active=act),
                       B.any_hit(bvh, o_t, d_t, tm, active=act))

    # the masked pair (K2, K4) on the same tree with random cell codes
    mbvh = _random_payload_tree(ts, "cuda")
    k = tc.closest_hit_soa_masked(mbvh, o3, d3, tm)
    p = B.closest_hit_masked(mbvh, o_t, d_t, tm)
    same = k["tri"] == p["tri"]
    assert bool((same | (k["t"] == p["t"])).all())
    for key in ("t", "u", "v", "mixed"):
        assert torch.equal(k[key][same], p[key][same])
    kb, kp = tc.any_hit_soa_masked(mbvh, o3, d3, tm, active=act)
    pb, pp = B.any_hit_masked(mbvh, o_t, d_t, tm, active=act)
    assert torch.equal(kb, pb) and torch.equal(kp, pp)
    assert bool(kp.any()) and bool(kb.any())


def _segment_cells(tree, o, d, t_max, t_min):
    """Brute force over every triangle row of a masked tree: (R,) bools,
    whether the segment (t_min, t_max) of each ray crosses an OPAQUE cell
    and whether it crosses a MIXED one."""
    from glaze_tpu_torch.accel import bvh as B

    r, n = o.shape[0], tree.tri.shape[0]
    t, u, v, hit = B._tri_intersect(tree.tri[None, :, :9].expand(r, n, 9),
                                    o[:, None, :], d[:, None, :])
    hit = hit & (t > t_min) & (t < t_max[:, None])
    words = B._payload_words(tree, torch.arange(n)[None].expand(r, n))
    code = B._mask_bits(words, u, v, hit)
    return (hit & (code == 1)).any(1), (hit & (code == 0)).any(1)


def _any_case_holds(name, kind):
    """The any-hit cases hold inactive lanes (never blocked), blocked and
    unblocked active lanes, and, masked, rays that end pending and rays
    that end blocked after crossing a MIXED cell; on the long lane, lanes
    that block in their first leaf share warps with lanes that walk the
    row."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.accel import fat
    from glaze_tpu_torch.accel import walk_cases as wc

    rows = {(label.split()[0], k): rest
            for label, k, *rest in wc.any_cases("cpu")
            if label.endswith(" 257 rays")}
    tree, o, d, t_max, t_min, act = rows[(name, kind)]
    walk = {"any": B.any_hit, "any_masked": B.any_hit_masked,
            "any_fat": fat.any_hit_fat}[kind]
    st = B.WalkStats()
    out = walk(tree, o, d, t_max, t_min=t_min, active=act, stats=st)
    blocked, pending = out if kind == "any_masked" else (out, None)
    assert int((~act).sum()) >= 80 and not bool(blocked[~act].any())
    assert int(blocked.sum()) >= 20 and int((act & ~blocked).sum()) >= 20
    if kind == "any_masked":
        assert int(pending.sum()) >= 5 and not bool((pending & blocked).any())
        opaque, mixed = _segment_cells(tree, o, d, t_max, t_min)
        assert torch.equal(blocked, opaque & act)
        assert int((blocked & mixed).sum()) >= 20
    if name == "long_lane":
        idx = torch.arange(o.shape[0])
        long_ = idx % 37 == 0
        block = ~long_ & (idx % 4 == 1) & act
        assert bool(act[long_].all()) and int(st.lane_steps[long_].min()) >= 10
        assert int(st.lane_steps[act & ~long_ & ~block].max()) == 1
        if kind != "any_masked":
            assert bool(blocked[block].all())
            assert int(st.lane_leaves[block].max()) == 1
            assert torch.equal(blocked[long_], idx[long_] % 74 == 0)
        assert st.warp_counters()["simd_efficiency"] < 0.2


@pytest.mark.parametrize("kind", ["closest", "masked", "any", "any_masked",
                                  "any_fat"])
@pytest.mark.parametrize("name", ["duplicates", "long_lane"])
def test_walk_cases_stress_the_warp(name, kind):
    """The cases the kernels are held to (accel/walk_cases.py) contain
    what they are meant to, on the plain walkers: duplicated triangles tie
    exactly and the first copy in the leaf is reported (on the masked
    tree, the first whose cell at the hit is not TRANSPARENT); a few lanes
    of the long-lane rays walk along the row while their warp's other
    lanes take one step. The any-hit kinds: see _any_case_holds."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.accel import walk_cases as wc

    if kind.startswith("any"):
        _any_case_holds(name, kind)
        return
    rows = {(label.split()[0], k): (tree, o, d, t_max)
            for label, k, tree, o, d, t_max in wc.cases("cpu")
            if label.endswith(" 257 rays")}
    tree, o, d, t_max = rows[(name, kind)]
    walk = B.closest_hit if kind == "closest" else B.closest_hit_masked
    st = B.WalkStats()
    out = walk(tree, o, d, t_max, stats=st)
    hit = out["tri"] >= 0
    if name == "duplicates":
        assert int(hit.sum()) > 150
        slot = out["tri"][hit].long()
        rows9 = tree.tri[:, :9]
        prev = torch.clamp(slot - 1, min=0)
        first_in_leaf = (slot % B.LEAF_SIZE == 0) | ~(rows9[prev] == rows9[slot]).all(1)
        if kind == "masked":  # the copy before it was skipped
            words = tree.tri[prev, 9:13].contiguous().view(torch.int32)
            code = B._mask_bits(words, out["u"][hit], out["v"][hit],
                                torch.ones_like(slot, dtype=torch.bool))
            first_in_leaf |= code == 2
        nxt = torch.clamp(slot + 1, max=tree.tri.shape[0] - 1)
        tied = (rows9[nxt] == rows9[slot]).all(1)
        assert bool(first_in_leaf.all()) and int(tied.sum()) > 100
    else:
        long_lanes = torch.arange(o.shape[0]) % 37 == 0
        assert int(st.lane_steps[~long_lanes].max()) == 1
        assert int(st.lane_steps[long_lanes].min()) >= 10
        assert st.warp_counters()["simd_efficiency"] < 0.2


@pytest.mark.cuda
def test_closest_kernels_walk_cases_on_cuda():
    """Needs a CUDA card (skips here): K1 and K2 against their plain
    walkers, bit for bit, on every case of accel/walk_cases.py (exact
    ties, 1/31/33/257 rays, one long lane per warp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from glaze_tpu_torch.accel import traverse_cuda as tc
    from glaze_tpu_torch.accel import walk_cases as wc

    assert wc.closest_mismatches("cuda", {"closest": tc.closest_hit_soa,
                                          "masked": tc.closest_hit_soa_masked}) == 0


@pytest.mark.cuda
def test_anyhit_kernels_walk_cases_on_cuda():
    """Needs a CUDA card (skips here): K3, K4 and K7a against their plain
    walkers, flag for flag, on every any-hit case of accel/walk_cases.py
    (inactive lanes, lanes that block in their first leaf beside lanes
    that walk the whole row, masked rays that end blocked, pending or
    both, 1/31/33/257 rays)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from glaze_tpu_torch.accel import traverse_cuda as tc
    from glaze_tpu_torch.accel import walk_cases as wc

    assert wc.any_mismatches("cuda", {"any": tc.any_hit_soa,
                                      "any_masked": tc.any_hit_soa_masked,
                                      "any_fat": tc.any_hit_fat_soa}) == 0
