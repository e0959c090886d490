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


NONE = np.iinfo(np.int32).max  # no column found
T_MIN32 = np.float32(1e-4)


def _split_drain_model(valid, t, cap, w):
    """NumPy model of K7c's drain of one leaf per row (csrc/traverse.cu
    closest_kernel_fat): lane r of a subgroup of w tests columns k = r (mod
    w) in ascending k with a strict <, then a butterfly over the subgroup
    keeps the smaller t and, on an exact tie, the smaller k. Returns the
    (t, k) every lane ends with (they must all agree)."""
    rows, T = t.shape
    bt = np.repeat(cap[:, None], w, 1)
    bk = np.full((rows, w), NONE, np.int64)
    for r in range(w):
        for k in range(r, T, w):
            take = valid[:, k] & (t[:, k] > T_MIN32) & (t[:, k] < bt[:, r])
            bt[take, r] = t[take, k]
            bk[take, r] = k
    lanes = np.arange(w)
    off = w // 2
    while off:
        ot, ok = bt[:, lanes ^ off], bk[:, lanes ^ off]
        swap = (ot < bt) | ((ot == bt) & (ok < bk))
        bt, bk = np.where(swap, ot, bt), np.where(swap, ok, bk)
        off //= 2
    assert (bt == bt[:, :1]).all() and (bk == bk[:, :1]).all()
    return bt[:, 0], bk[:, 0]


def _sequential_scan(valid, t, cap):
    """The column loop K7c ran before (and the Pallas kernel's order):
    k = 0..T-1, replace the best when T_MIN < t < best."""
    bt, bk = cap.copy(), np.full(cap.shape, NONE, np.int64)
    for k in range(t.shape[1]):
        take = valid[:, k] & (t[:, k] > T_MIN32) & (t[:, k] < bt)
        bt[take] = t[take, k]
        bk[take] = k
    return bt, bk


def _drain_columns(T):
    """(valid, t, cap) rows of T columns: synthetic rows drawn from a few
    float32 values (exact ties, t at T_MIN and at the cap, misses, infs),
    then real rows of leaves of triangles that each appear three times
    (fat._leaf_columns of rays aimed at them)."""
    from glaze_tpu_torch.accel import fat, walk_cases

    rng = np.random.default_rng(53 + T)
    vals = np.float32([-1.0, 0.0, 5e-5, 1e-4, 0.5, 1.0, 1.0, 2.0, 3.0, 7.5,
                       40.0, np.inf])
    t = rng.choice(vals, (96, T)).astype(np.float32)
    valid = rng.uniform(size=(96, T)) < 0.7
    valid[:4] = False  # no column at all
    t[4:8] = np.maximum(t[4:8], np.float32(7.5))  # none below the cap
    cap = rng.choice(np.float32([np.inf, 2.0, 1.0, 7.5]), 96).astype(np.float32)
    cap[4:8] = 7.5
    tri, o, d = walk_cases.duplicate_soup(n=max(8, T), n_rays=64, seed=54 + T)
    b, _ = fat.build_bvh_fat(tri, "cpu", T)
    n_leaves = b.coef.shape[0] // T
    feat = fat._ray_features(_t(o), _t(d))
    slots = torch.arange(n_leaves * T).view(n_leaves, T)
    rv, rt, _, _, _ = fat._leaf_columns(
        b.coef, slots.repeat(len(o), 1),
        feat.repeat_interleave(n_leaves, 0))
    rv, rt = rv.numpy(), rt.numpy()
    keep = rv.any(1)
    assert keep.sum() >= 16
    rt = np.where(rv, rt, np.float32(0.0))  # the kernel never reads these
    return (np.concatenate([valid, rv[keep]]), np.concatenate([t, rt[keep]]),
            np.concatenate([cap, np.full(int(keep.sum()), np.inf, np.float32)]))


@pytest.mark.parametrize("T", [8, 20, 128])
@pytest.mark.parametrize("w", [1, 2, 4, 8, 16, 32])
def test_split_drain_reduction_order(w, T):
    """K7c's split drain keeps the sequential scan's result bit for bit
    for every subgroup width, exact ties included (the lowest column
    wins), and so does the plain walker's selection (fat.closest_column,
    torch.min's first index)."""
    from glaze_tpu_torch.accel import fat

    valid, t, cap = _drain_columns(T)
    mt, mk = _split_drain_model(valid, t, cap, w)
    st, sk = _sequential_scan(valid, t, cap)
    assert np.array_equal(mt.view(np.int32), st.view(np.int32))
    assert np.array_equal(mk, sk)
    tmin, kmin, better = fat.closest_column(_t(valid), _t(t), _t(cap))
    pt = np.where(better.numpy(), tmin.numpy(), cap)
    pk = np.where(better.numpy(), kmin.numpy(), NONE)
    assert np.array_equal(pt.view(np.int32), st.view(np.int32))
    assert np.array_equal(pk, sk)
    # the rows hold exact ties that the rule decides, and misses
    ties = [(valid[i] & (t[i] == st[i])).sum() > 1 for i in range(len(st))]
    assert sum(ties) >= 8 and (sk == NONE).sum() >= 4 and (sk != NONE).sum() >= 16


FULL32 = 0xFFFFFFFF


def _nth_set_bit(m, s):
    """csrc/traverse.cu nth_set_bit: the position of the (s+1)-th set bit
    of the 32-bit mask m, by halving."""
    pos = 0
    width = 16
    while width >= 1:
        low = m & ((1 << width) - 1)
        c = bin(low).count("1")
        if s >= c:
            s -= c
            m >>= width
            pos += width
        else:
            m = low
        width >>= 1
    return pos


def _split_or_model(parked, hits):
    """NumPy model of K7a's drain (csrc/traverse.cu anyhit_kernel_fat) for
    one warp: ``parked`` the 32-bit ballot of parked lanes, ``hits`` (32,
    T) bool, row l the hit columns (t in (t_min, cap)) of lane l's leaf.
    With g parked lanes, w = 32 >> (32 - clz(g - 1)); lane r of subgroup
    s = lane // w scans columns r, r + w, ... of the owner's leaf and
    stops at its first hit; one ballot of the lanes that found one; each
    owner reads the w bits from rank * w. Returns the owners' flags
    {lane: bool} and the columns each lane scanned."""
    g = bin(parked).count("1")
    clz = 32 - (g - 1).bit_length()  # __clz(g - 1), 32 for g = 1
    w = 32 >> (32 - clz)
    T = hits.shape[1]
    votes, scanned = 0, np.zeros(32, np.int64)
    for lane in range(32):
        sub = lane // w
        if sub >= g:
            continue
        owner = _nth_set_bit(parked, sub)
        for k in range(lane - sub * w, T, w):
            scanned[lane] += 1
            if hits[owner, k]:
                votes |= 1 << lane
                break
    flags = {}
    for lane in range(32):
        if parked >> lane & 1:
            rank = bin(parked & ((1 << lane) - 1)).count("1")
            sub_mask = FULL32 >> (32 - w)  # defined for w = 32, as 1 << 32 is not
            flags[lane] = bool((votes >> (rank * w)) & sub_mask)
    return flags, scanned, w


@pytest.mark.parametrize("g", range(1, 33))
def test_split_or_drain_matches_sequential_scan(g):
    """K7a's subgroup OR and owner read-back give every parked lane the
    flag of the sequential column scan (any column with t in (t_min,
    cap)), for g parked lanes at scattered and packed positions and T =
    8, 20, 128 (hits rare, dense, none, or only in the last column); every
    column of a leaf without a hit is scanned once."""
    rng = np.random.default_rng(70 + g)
    for T in (8, 20, 128):
        for trial in range(6):
            lanes = (np.arange(g) if trial == 0
                     else np.sort(rng.choice(32, g, replace=False)))
            parked = int(sum(1 << int(lane) for lane in lanes))
            assert _nth_set_bit(parked, g - 1) == lanes[-1]
            p = (0.002, 0.02, 0.3, 0.0, 0.0, 0.05)[trial]
            hits = rng.uniform(size=(32, T)) < p
            if trial == 4:
                hits[lanes[::2], T - 1] = True
            flags, scanned, w = _split_or_model(parked, hits)
            assert w * (1 << (g - 1).bit_length()) == 32
            assert sorted(flags) == list(lanes)
            for lane in lanes:
                assert flags[lane] == bool(hits[lane].any()), (g, T, trial, lane)
            for sub, lane in enumerate(lanes):
                if not hits[lane].any():
                    assert scanned[sub * w:(sub + 1) * w].sum() == T


@pytest.mark.parametrize("mode", ["classic", "fat"])
def test_per_lane_counts_sum_to_totals(mode, monkeypatch):
    """The per-lane counters of the plain closest walkers on the tiny
    scene sum back to the walk's totals: node steps to ``node_visits``,
    leaves entered x T to ``col_tests`` on the fat tree (each entered leaf
    tests all T columns) and to between tri_tests / 8 and tri_tests on the
    classic one; the warp counters follow from them."""
    from glaze_tpu_torch.accel import bvh as B
    from glaze_tpu_torch.accel import fat
    from glaze_tpu_torch.scene import flatten_scene

    monkeypatch.setenv("GLAZE_TREE", mode)
    scene, _, _ = flatten_scene(_tiny_parsed(), "cpu")
    tree = scene.bvh
    rng = np.random.default_rng(52)
    n = 333  # a ragged last warp
    o = rng.uniform([-1.5, 0.2, -1.5], [1.5, 2.5, 1.5], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    st = B.WalkStats()
    if mode == "fat":
        assert isinstance(tree, fat.FatBVH)
        fat.closest_hit_fat(tree, _t(o), _t(d), stats=st)
        assert int(st.lane_leaves.sum()) * tree.leaf_size == st.col_tests
    else:
        B.closest_hit(tree, _t(o), _t(d), stats=st)
        leaves = int(st.lane_leaves.sum())
        assert st.tri_tests / B.LEAF_SIZE <= leaves <= st.tri_tests
    assert st.lane_steps.shape == (n,) and int(st.lane_steps.min()) >= 1
    assert int(st.lane_steps.sum()) == st.node_visits
    w = st.warp_counters()
    steps = np.pad(st.lane_steps.numpy(), (0, -n % 32)).reshape(-1, 32)
    leaves = np.pad(st.lane_leaves.numpy(), (0, -n % 32)).reshape(-1, 32)
    assert w["simd_efficiency"] == pytest.approx(
        steps.sum() / (32 * steps.max(1).sum()))
    assert w["mean_leaves_per_lane"] == pytest.approx(leaves.sum() / n)
    assert w["mean_warp_max_leaves"] == pytest.approx(leaves.max(1).mean())
    assert 0 < w["simd_efficiency"] <= 1
    assert w["mean_warp_max_leaves"] >= w["mean_leaves_per_lane"] > 0


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
    from glaze_tpu_torch import cuda_build
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
    monkeypatch.setattr(cuda_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(tc, "LIBRARY", "absent.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        tc._load()
    tc.reset_launch_counts()
    assert tc.closest_hit_fat_soa.launches == tc.any_hit_fat_soa.launches == 0


def test_build_follows_every_csrc_source(monkeypatch, tmp_path):
    """A library is rebuilt when its own source or a header it includes
    (directly or through another header) is newer than it (here: it tries
    nvcc, stubbed to raise); another library's source does not touch
    it."""
    from glaze_tpu_torch import cuda_build
    from glaze_tpu_torch.accel import traverse_cuda as tc

    src = tmp_path / "csrc"
    src.mkdir()
    build_dir = tmp_path / "build"
    build_dir.mkdir()
    for name, text in (("traverse.cu", '#include "extra.cuh"\n'),
                       ("extra.cuh", '#include "nested.cuh"\n'),
                       ("nested.cuh", "//"), ("probes.cu", "//")):
        (src / name).write_text(text)
        os.utime(src / name, (1000, 1000))
    so = build_dir / tc.LIBRARY
    so.write_text("")
    os.utime(so, (2000, 2000))
    monkeypatch.setattr(cuda_build, "CSRC", str(src))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build_dir))
    assert tc.build() == str(so)  # up to date: no compiler needed
    os.utime(src / "probes.cu", (3000, 3000))
    assert tc.build() == str(so)  # another library's source
    monkeypatch.setattr(cuda_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    assert cuda_build.build("traverse.cu", tc.LIBRARY) == (str(so), "")
    assert cuda_build.local_headers("traverse.cu") == ["extra.cuh", "nested.cuh"]
    os.utime(src / "nested.cuh", (3000, 3000))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build("traverse.cu", tc.LIBRARY)
    os.utime(src / "traverse.cu", (3000, 3000))
    with pytest.raises(RuntimeError, match="nvcc"):
        tc.build()
    assert sorted(os.listdir(build_dir)) == [tc.LIBRARY]  # no temp left


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


@pytest.mark.cuda
def test_fat_kernel_walk_cases_on_cuda():
    """Needs a CUDA card (skips here): K7c against its plain walker, bit
    for bit, on every case of accel/walk_cases.py (leaves of T = 20 with
    exact ties, 1/31/33/257 rays, one long lane per warp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from glaze_tpu_torch.accel import traverse_cuda as tc
    from glaze_tpu_torch.accel import walk_cases as wc

    assert wc.closest_mismatches("cuda", {"fat": tc.closest_hit_fat_soa}) == 0


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
