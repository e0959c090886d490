"""The probe tools (glaze_tpu_torch.tools) against the TPU tools in tools/.

On the CPU each probe's plain torch version (the kernel's counterpart) is
held against the tool's own Pallas kernel, run in interpret mode, on the
same NumPy inputs; nothing in tools/ changes for that. XLA:CPU computes an
f32 product at DEFAULT precision in full f32, so the port's ``default``
(one bf16 pass) is held against a NumPy model of that pass instead.
Tolerances:

* drain products (T1, T3b) at ``highest``: the port sums the exact
  3xTF32 partial products (hi*hi + hi*lo + lo*hi, about 21 bits of each
  operand), XLA:CPU the f32 products, so t agrees to 1e-4 relative and u,
  v (det-scaled, divided by det) to 1e-3 absolute; the winning triangle
  exactly. Kernel against plain (on a card): the same products summed in
  another order, t to 1e-4 relative, u, v to 5e-3.
* product chains (T3a): the (8, 128) sums agree to 1e-5 of their largest
  magnitude (a few f32 ulps of the summands).
* the walk (T2): iteration counts and B/C/D outputs exactly; A's sums of
  t within 1e-4 relative (XLA:CPU rounds Moller-Trumbore differently,
  ROADMAP F8).
* slab rates (T4): f32 and bf16 outputs exactly.

The kernels run only on a card: the ``cuda``-marked tests hold each
against its plain version at small sizes, and chip_smoke.py at the tools'
sizes. What the CPU can check of the drain kernel's register resolve (the
lane that holds each (triangle, ray) pair, the order of its tests, the
shuffle reduction and the fold) is a NumPy model of it, held bit for bit
against the plain resolve. Likewise the chain kernel's schedule (the warps'
m-tiles, C-operand accumulation, the sign flip of the split features, the
sum across warps) is a NumPy model held within 1e-5 of the plain chain,
and the walk kernel's leaf lists (packet 2048) and pairs (packet 32) a
model held bit for bit against the plain walk.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from glaze_tpu_torch.accel.bvh import _tri_intersect as bvh_intersect  # noqa: E402
from glaze_tpu_torch.tools import (bench_bf16_slab, bench_dot,  # noqa: E402
                                   bench_mxu, exp_overhead, probes_cuda)

T_RTOL = 1e-4
UV_ATOL = 1e-3
# kernel against plain: the same exact products summed in another order;
# ud, vd agree to a few ulps of terms ~20, divided by a grazing det ~0.01
KERNEL_UV_ATOL = 5e-3
CHAIN_RTOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in interpret mode for the tools' kernels."""
    orig = pl.pallas_call

    def call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", call)


@pytest.fixture
def first_result(monkeypatch):
    """The first array each tool run hands to jax.block_until_ready (its
    untimed call, on the unperturbed inputs)."""
    seen = []
    orig = jax.block_until_ready

    def spy(x):
        seen.append(x)
        return orig(x)

    monkeypatch.setattr(jax, "block_until_ready", spy)
    return seen


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# T1: the fat-leaf drain


def _cloud(T, seed=5, leaves=3):
    """A triangle cloud of ``leaves`` leaves and 128 rays aimed at its
    triangles' centroids (so that most rays hit), with a leaf order that
    visits every leaf, some twice."""
    rng = np.random.default_rng(seed)
    n = leaves * T - 3  # a padded last leaf
    base = rng.uniform(-20, 20, (n, 1, 3))
    tri = (base + rng.uniform(-0.6, 0.6, (n, 3, 3))).astype(np.float32)
    o = rng.uniform(-22, 22, (128, 3)).astype(np.float32)
    tgt = tri.mean(1)[rng.integers(0, n, 128)]
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.zeros((8, 128), np.float32)
    rays[0:3] = o.T
    rays[3:6] = d.T
    order = np.concatenate([rng.permutation(leaves),
                            rng.integers(0, leaves, leaves)]).astype(np.int32)
    return tri, rays, order


@pytest.mark.parametrize("T", [16, 32, 128])
def test_leaf_matrices_bit_equal_to_tool(T):
    from tools import bench_mxu as tool

    tri, _, _ = _cloud(T)
    m_t, c_t = tool.leaf_matrices(tri, T)
    m_p, c_p = bench_mxu.leaf_matrices(tri, T)
    assert m_p.dtype == m_t.dtype and np.array_equal(m_p, m_t)
    assert np.array_equal(c_p, c_t)


def _port_drain(mats, centres, rays, order, T, precision):
    L = mats.shape[0]
    out = bench_mxu.drain_probe(
        torch.from_numpy(mats.reshape(L * 16, -1)), torch.from_numpy(centres),
        torch.from_numpy(rays), torch.from_numpy(order), T, precision)
    return [x.numpy() for x in out]


def _assert_drain_close(got, want, label, uv_atol=UV_ATOL):
    (tp, ip, up, vp), (tw, iw, uw, vw) = got, want
    assert np.array_equal(ip, iw), f"{label}: tri differs"
    hit = iw[0] >= 0
    assert hit.sum() >= 32, f"{label}: only {hit.sum()} hits"
    assert np.array_equal(tp[:, ~hit], tw[:, ~hit])
    assert np.array_equal(tp[1:], tw[1:]) and np.array_equal(up[1:], uw[1:])
    rel = np.abs(tp[0, hit] - tw[0, hit]) / tw[0, hit]
    assert rel.max() <= T_RTOL, f"{label}: rel t err {rel.max()}"
    assert np.abs(up - uw).max() <= uv_atol and np.abs(vp - vw).max() <= uv_atol


@pytest.mark.parametrize("T", [16, 32])
def test_drain_highest_matches_tool_kernel(T, interpret):
    from tools import bench_mxu as tool

    tri, rays, order = _cloud(T)
    mats, centres = tool.leaf_matrices(tri, T)
    L = mats.shape[0]
    fn = tool.make_kernel(T, L, len(order), "highest")
    want = [np.asarray(x) for x in fn(
        jnp.asarray(order), jnp.asarray(mats.reshape(L * 16, -1)),
        jnp.asarray(centres), jnp.asarray(rays))]
    got = _port_drain(mats, centres, rays, order, T, "highest")
    _assert_drain_close(got, want, f"T={T} highest")


def _bf16(x):
    return np.asarray(x, np.float32).astype(jnp.bfloat16).astype(np.float64)


def _np_drain_bf16(mats, centres, rays, order, T):
    """NumPy model of the drain at ``default``: one bf16 pass (operands
    rounded to nearest even, exact products summed in float64, rounded to
    f32), then the tool's resolve (bench_mxu.py:138-163) step by step."""
    r = rays.shape[1]
    bt = np.full(r, np.inf, np.float32)
    bi = np.full(r, -1, np.int32)
    bu = np.zeros(r, np.float32)
    bv = np.zeros(r, np.float32)
    o, d = rays[0:3], rays[3:6]
    for leaf in order:
        c = centres[leaf]
        px, py, pz = o[0] - c[0], o[1] - c[1], o[2] - c[2]
        feat = np.zeros((16, r), np.float32)
        feat[0:3] = [py * d[2] - pz * d[1], pz * d[0] - px * d[2],
                     px * d[1] - py * d[0]]
        feat[3:6] = [px, py, pz]
        feat[6:9] = d
        feat[9] = 1.0
        out = (_bf16(mats[leaf][:, :4 * T]).T @ _bf16(feat)).astype(np.float32)
        det, ud, vd, td = (out[i * T:(i + 1) * T] for i in range(4))
        ok = np.abs(det) >= bench_mxu.DET_EPS
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(ok, np.float32(1.0) / np.where(det == 0, 1, det), 0)
            inv = inv.astype(np.float32)
            t = td * inv
            valid = (ok & (ud * det >= 0) & (vd * det >= 0)
                     & ((ud + vd) * det <= det * det) & (t > 1e-4) & (t < bt))
        tt = np.where(valid, t, np.inf)
        tmin = tt.min(0)
        w = np.where(tt <= tmin, np.arange(T)[:, None], T).min(0)
        better = tmin < bt
        cols = np.minimum(w, T - 1)
        bt = np.where(better, tmin, bt).astype(np.float32)
        bi = np.where(better, leaf * T + w, bi).astype(np.int32)
        bu = np.where(better, (ud * inv)[cols, np.arange(r)], bu)
        bv = np.where(better, (vd * inv)[cols, np.arange(r)], bv)
    return bt, bi, bu, bv


@pytest.mark.parametrize("T", [16, 64])
def test_drain_default_matches_bf16_model(T):
    tri, rays, order = _cloud(T, seed=9)
    mats, centres = bench_mxu.leaf_matrices(tri, T)
    tp, ip, up, vp = _port_drain(mats, centres, rays, order, T, "default")
    tm, im, um, vm = _np_drain_bf16(mats, centres, rays, order, T)
    assert np.array_equal(ip[0], im)
    hit = im >= 0
    assert hit.sum() >= 16
    assert np.allclose(tp[0], tm, rtol=1e-6, atol=0)
    assert np.allclose(up[0], um, atol=1e-6) and np.allclose(vp[0], vm, atol=1e-6)


@pytest.mark.parametrize("x", [1.0, -1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                               -(1.0 + 2 ** -11), 3.0e38, float("inf")])
def test_tf32_round_is_nearest_away(x):
    """cvt.rna.tf32.f32: 10 mantissa bits, ties away from zero."""
    got = float(bench_mxu.tf32_round(torch.tensor([x], dtype=torch.float32)))
    f = np.float32(x)
    if not np.isfinite(f):
        assert got == x
        return
    m, e = np.frexp(np.float64(f))           # f = m * 2**e, 0.5 <= |m| < 1
    q = np.abs(m) * 2 ** 11                  # 11 significant bits
    want = np.sign(m) * np.floor(q + 0.5) * 2.0 ** (e - 11)
    assert got == np.float32(want)


def test_drain_run_entry_on_cpu(capsys):
    res = bench_mxu.run(16, "highest", "cpu")
    assert res["hit_agree"] == 1.0 and res["id_agree"] == 1.0
    assert res["times"] == {}
    assert "hit agree" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# T1 / T3b: a NumPy model of drain_kernel's register resolve

WARPS, TILES = 4, 4  # warps of a drain block, n8 ray tiles of a warp
F32 = np.float32


def _fragment_step(out, T):
    """drain_kernel's resolve of one step's (4T, 128) f32 product, lane by
    lane. Lane (g, q) of warp w holds, for ray tile j, the accumulators of
    rows g and g + 8 of every m16 tile (triangles m0 + g, m0 + g + 8) at
    columns 2q, 2q + 1 (slots h = 0, 1): ray (4w + j) * 8 + 2q + h. The
    four quantities of a pair are slab columns qty * T + triangle, so they
    share the slot. Each slot takes its valid pairs in ascending triangle
    order with a strict < (the kernel tests inside first and divides only
    for the pairs that pass: the same operations on those pairs, so the
    same bits); then xor shuffles over 4, 8 and 16 lanes keep
    the (t, column) least, and u, v come from lane ((column % 8) << 2) | q.
    Returns the step's (128,) t (inf: none), column, u, v per ray."""
    out = np.asarray(out, F32)
    w, lane, j, h = np.meshgrid(np.arange(WARPS), np.arange(32),
                                np.arange(TILES), np.arange(2), indexing="ij")
    g, q = lane >> 2, lane & 3
    ray = (w * TILES + j) * 8 + 2 * q + h
    ct = np.full(ray.shape, np.inf, F32)
    cc = np.full(ray.shape, T, np.int32)
    cu = np.zeros(ray.shape, F32)
    cv = np.zeros(ray.shape, F32)
    for m0 in range(0, T, 16):
        for r in (0, 1):
            col = m0 + g + 8 * r
            det, ud, vd, td = (out[k * T + col, ray] for k in range(4))
            ok = np.abs(det) >= F32(bench_mxu.DET_EPS)
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                inv = np.where(ok, F32(1.0) / np.where(ok, det, F32(1.0)),
                               F32(0.0))
                t = td * inv
                take = (ok & (ud * det >= 0) & (vd * det >= 0)
                        & ((ud + vd) * det <= det * det)
                        & (t > F32(bench_mxu.T_MIN)) & (t < ct))
                ct = np.where(take, t, ct)
                cc = np.where(take, col, cc).astype(np.int32)
                cu = np.where(take, ud * inv, cu)
                cv = np.where(take, vd * inv, cv)
    t, c = ct, cc
    for s in (4, 8, 16):
        t2, c2 = t[:, np.arange(32) ^ s], c[:, np.arange(32) ^ s]
        take = (t2 < t) | ((t2 == t) & (c2 < c))
        t, c = np.where(take, t2, t), np.where(take, c2, c)
    src = ((c & 7) << 2) | q
    u = np.take_along_axis(cu, src, axis=1)
    v = np.take_along_axis(cv, src, axis=1)
    res = [np.zeros(128, x.dtype) for x in (t, c, u, v)]
    for x, y in zip(res, (t, c, u, v)):
        by_g = y.view(np.int32).reshape(WARPS, 8, 4, TILES, 2)
        assert (by_g == by_g[:, :1]).all()  # the 8 lanes of a q agree
        x[ray[:, :4]] = y[:, :4]  # lanes g = 0 write
    return res


def _fragment_fold(best, leaf, T, step):
    """Each slot folds the step's winner into the ray's best with a strict
    <. Returns the new best and the (128,) mask of rays that improved."""
    t, c, u, v = step
    better = t < best["t"]
    return {"t": np.where(better, t, best["t"]),
            "tri": np.where(better, leaf * T + c, best["tri"]).astype(np.int32),
            "u": np.where(better, u, best["u"]),
            "v": np.where(better, v, best["v"])}, better


def _np_best(t_init):
    return {"t": np.full(128, t_init, F32), "tri": np.full(128, -1, np.int32),
            "u": np.zeros(128, F32), "v": np.zeros(128, F32)}


def _assert_bits_equal(model, plain, label):
    for k in ("t", "tri", "u", "v"):
        a, b = np.asarray(model[k]), plain[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.int32), b.view(np.int32)), f"{label}: {k} differs"


def _equal_t_products(T, seed):
    """Three steps of synthetic (4T, 128) products with exact ties of t:
    every pair of :func:`bench_mxu.tie_pairs` shares det and t*det with
    another u, v and the least t of the step (so the lower column must
    win, with its own u, v); step 1 repeats step 0's det and t*det with
    other u, v (the earlier step must stay); rays 112-127 have det 0 (no
    hit)."""
    rng = np.random.default_rng(seed)

    def uvs():
        return (rng.uniform(-0.1, 0.6, (T, 128)).astype(F32),
                rng.uniform(-0.1, 0.6, (T, 128)).astype(F32))

    def step(det, t, u, v):
        return np.concatenate([det, u * det, v * det, t * det]).astype(F32)

    det = (rng.uniform(0.5, 2.0, (T, 128))
           * rng.choice([-1.0, 1.0], (T, 128))).astype(F32)
    t = rng.uniform(1.0, 50.0, (T, 128)).astype(F32)
    for c, copy in bench_mxu.tie_pairs(T):
        t[c] = rng.uniform(0.2, 0.9, 128)
        det[copy], t[copy] = det[c], t[c]
    det[:, 112:] = 0.0
    first = step(det, t, *uvs())
    det2 = (rng.uniform(0.5, 2.0, (T, 128))).astype(F32)
    det2[:, 112:] = 0.0
    return [first, step(det, t, *uvs()),
            step(det2, rng.uniform(0.1, 50.0, (T, 128)).astype(F32), *uvs())]


def _t1_products(inp, T, n_miss=16):
    """The per-step (4T, 128) products (``highest``) of a T1 input's first
    128 rays, the last ``n_miss`` of them with a zero direction (det 0:
    no hit)."""
    rays = torch.from_numpy(inp["rays"][:, :128].copy())
    rays[3:6, 128 - n_miss:] = 0.0
    slabs = torch.from_numpy(inp["mats"]).reshape(-1, 16, inp["mats"].shape[1])
    centres = torch.from_numpy(inp["centres"])
    return [bench_mxu.product_plain(
        slabs[leaf, :, :4 * T], bench_mxu.ray_features(
            rays[0:3], rays[3:6], centres[leaf]), "highest").numpy()
        for leaf in inp["order"]]


@pytest.mark.parametrize("T", probes_cuda.TS)
@pytest.mark.parametrize("case", ["ties", "equal_t", "cloud"])
def test_fragment_resolve_model_matches_plain(T, case):
    """The lane model of the register resolve against resolve_plain +
    fold_leaf, bit for bit, step by step."""
    if case == "ties":
        inp = bench_mxu.tie_inputs(T)
        outs = _t1_products(inp, T)
        leaves = list(inp["order"])
    elif case == "cloud":
        tri, rays, order = _cloud(T)
        mats, centres = bench_mxu.leaf_matrices(tri, T)
        inp = dict(mats=mats.reshape(-1, mats.shape[2]), centres=centres,
                   rays=rays, order=order)
        outs = _t1_products(inp, T)
        leaves = list(inp["order"])
    else:
        outs = _equal_t_products(T, seed=T)
        leaves = [0, 1, 2]
    model = _np_best(np.inf)
    plain = bench_mxu.no_hits(128, "cpu")
    tied = np.unique(bench_mxu.tie_pairs(T))
    tied_wins = 0  # step winners in a column that has a copy
    for k, (leaf, out) in enumerate(zip(leaves, outs)):
        step = _fragment_step(out, T)
        model, won = _fragment_fold(model, int(leaf), T, step)
        plain, better = bench_mxu.fold_leaf(
            plain, int(leaf), T, *bench_mxu.resolve_plain(torch.from_numpy(out), T))
        assert np.array_equal(won, better.numpy()), f"{case} step {k}"
        _assert_bits_equal(model, plain, f"T={T} {case} step {k}")
        tied_wins += int(np.isin(step[1][np.isfinite(step[0])], tied).sum())
    hit = model["tri"] >= 0
    assert hit.sum() >= 32 and not hit[112:].any()
    if case != "cloud":
        assert tied_wins >= 32, tied_wins


@pytest.mark.parametrize("T", probes_cuda.TS)
def test_fragment_resolve_model_carry_matches_plain(T):
    """T3b: the lane model with feat + carry, the carry read from ray 0's
    slot (warp 0, lane 0, tile 0), against resolve_chain_plain."""
    reps = 6
    mat, feat = bench_dot.chain_inputs(4 * T, "cpu")
    model = _np_best(bench_dot.T_INIT)
    carry = F32(0.0)
    for _ in range(reps):
        out = bench_mxu.product_plain(mat[:, :4 * T], feat + torch.tensor(carry),
                                      "highest").numpy()
        model, won = _fragment_fold(model, 0, T, _fragment_step(out, T))
        carry = F32(carry + (model["t"][0] if won[0] else F32(np.inf))
                    * F32(1e-30))
    plain = bench_dot.resolve_chain_plain(mat, feat, T, reps)
    _assert_bits_equal(model, plain, f"T3b T={T}")
    assert (model["tri"] >= 0).any()


def test_drain_digests_cover_every_case_on_cpu():
    """The digest tool's cases, through the plain drains on the CPU."""
    from glaze_tpu_torch.tools import drain_digests

    kw = dict(ts=(16,), reps=3, chain=(2,), slab_rows=(16,), slab_iters=5)
    got = drain_digests.digests("cpu", **kw)
    want = {f"T1_T16_{p}_{c}" for p in bench_mxu.PRECISIONS
            for c in ("check", "reps3", "aimed", "ties")} | {
        "T3b_T16_2", "T4_f32_16", "T4_bf16_16"}
    assert set(got) == want
    assert all(len(v) == 64 for v in got.values())
    assert got == drain_digests.digests("cpu", **kw)


# ---------------------------------------------------------------------------
# T3a / T3b: product chains


def _chain_cases():
    return [(16, 1, "highest", False), (16, 2, "default", True),
            (32, 1, "highest", False)]


@pytest.mark.parametrize("T,batch,precision,split3", _chain_cases())
def test_dot_chain_matches_tool_kernel(T, batch, precision, split3,
                                       interpret, first_result):
    from tools import bench_dot as tool

    tool.run_case(T, batch, precision, split3, reps=8)
    want = np.asarray(first_result[0])
    mat, feat = bench_dot.chain_inputs(4 * T * batch, "cpu")
    got, _ = bench_dot.dot_chain_probe(mat, feat,
                                       "split3" if split3 else precision, 8)
    err = np.abs(got.numpy() - want).max()
    assert err <= CHAIN_RTOL * np.abs(want).max(), err


def test_dot_chain_default_matches_bf16_model():
    """XLA:CPU ignores DEFAULT for f32 products: the one-pass bf16 chain is
    held against a NumPy model of it."""
    mat, feat = bench_dot.chain_inputs(128, "cpu")
    got, trace = bench_dot.dot_chain_probe(mat, feat, "default", 8, trace=True)
    m, f0 = mat.numpy(), feat.numpy()
    acc = np.zeros((8, 128), np.float32)
    for _ in range(8):
        f = np.where(f0 > acc[0, 0], f0, -f0)
        out = (_bf16(m).T @ _bf16(f)).astype(np.float32)
        acc = acc + out.reshape(-1, 8, 128).sum(0)
    assert np.abs(got.numpy() - acc).max() <= CHAIN_RTOL * np.abs(acc).max()
    assert trace.shape == (8,) and float(trace[-1]) == float(got[0, 0])


def test_first_flip_finds_the_first_differing_step():
    feat = torch.tensor([[0.5, -1.0, 2.0]])
    a = torch.tensor([0.1, 0.2, 0.3, 0.4])
    assert bench_dot.first_flip(feat, a, a.clone()) == (None, 0)
    b = torch.tensor([0.1, 0.6, 0.3, 0.7])   # 0.6 flips step 2, 0.7 none
    assert bench_dot.first_flip(feat, a, b) == (2, 1)


def test_resolve_chain_matches_tool_kernel(interpret, first_result):
    from tools import bench_dot as tool

    tool.run_resolve_case(16, reps=6)
    want = [np.asarray(x) for x in first_result[0]]
    mat, feat = bench_dot.chain_inputs(64, "cpu")
    got = [x.numpy() for x in bench_dot.resolve_chain_probe(mat, feat, 16, 6)]
    _assert_drain_close(got, want, "resolve chain")


# ---------------------------------------------------------------------------
# T3a: a NumPy model of dot_chain_kernel's schedule

CHAIN_MGROUPS, CHAIN_NTILES = 4, 16  # m-tile strides; n8 tiles of 128 rays
K_STEPS = {"highest": 2, "default": 1, "split3": 1}  # k8 tf32 / k16 bf16


def _parts(x, precision):
    """The operand parts of ``x`` the tensor cores multiply: [hi, lo], or
    [the one bf16 part] at ``default``, as float64."""
    t = torch.from_numpy(np.asarray(x, F32))
    pairs = bench_mxu.operand_parts(t, t, precision)
    parts = [pairs[0][0]] if len(pairs) == 1 else [pairs[0][0], pairs[2][0]]
    return [p.double().numpy() for p in parts]


def _chain_model(mat, feat, precision, reps):
    """dot_chain_kernel's schedule: the matrix split once; m-group mg (the
    warps w % 4 == mg of both column halves) takes m-tiles mg, mg + 4, ...
    and accumulates them in its C operand (each mma rounds its k-step's
    exact sum onto C); rows g and g + 8 fold into row g once per step into
    the m-group's partial; a00 is the m-groups' partials of acc[0, 0]
    summed in order, and the output their partials summed once at the end
    in the same order. The B parts are the split of feat, sign-flipped
    where feat <= a00. Returns (acc, trace, mma instructions per step)."""
    m, f0 = mat.numpy(), feat.numpy()
    w = m.shape[1]
    n_mt = w // 16
    a_parts = _parts(m, precision)
    b_split = _parts(f0, precision)
    pairs = [(0, 0)] if precision == "default" else [(0, 0), (0, 1), (1, 0)]
    ks = K_STEPS[precision]
    kw = 16 // ks
    part = np.zeros((CHAIN_MGROUPS, 8, 128), F32)
    a00 = F32(0.0)
    trace, count = [], 0
    for _ in range(reps):
        sign = np.where(f0 > a00, 1.0, -1.0)
        b_parts = [b * sign for b in b_split]
        count = 0
        for mg in range(CHAIN_MGROUPS):
            c = np.zeros((16, 128), F32)
            for mt in range(mg, n_mt, CHAIN_MGROUPS):
                for ia, ib in pairs:
                    for s in range(ks):
                        k = slice(kw * s, kw * (s + 1))
                        prod = a_parts[ia][k, 16 * mt:16 * mt + 16].T @ b_parts[ib][k]
                        c = (c.astype(np.float64) + prod).astype(F32)
                        count += CHAIN_NTILES
            part[mg] = part[mg] + (c[:8] + c[8:])
        a00 = part[0, 0, 0]
        for mg in range(1, CHAIN_MGROUPS):
            a00 = F32(a00 + part[mg, 0, 0])
        trace.append(a00)
    out = part[0]
    for mg in range(1, CHAIN_MGROUPS):
        out = out + part[mg]
    return out, np.asarray(trace, F32), count


@pytest.mark.parametrize("precision", ["highest", "default", "split3"])
def test_chain_schedule_model_matches_plain(precision):
    mat, feat = bench_dot.chain_inputs(256, "cpu")
    got, trace, _ = _chain_model(mat, feat, precision, 8)
    want, tr_p = bench_dot.dot_chain_plain(mat, feat, precision, 8, trace=True)
    assert bench_dot.first_flip(feat, torch.from_numpy(trace), tr_p)[0] is None
    err = np.abs(got - want.numpy()).max()
    assert err <= CHAIN_RTOL * np.abs(want.numpy()).max(), err
    assert got[0, 0] == trace[-1]  # out[0, 0] sums as a00 does


@pytest.mark.parametrize("w", [16, 512, 2048])
@pytest.mark.parametrize("precision", ["highest", "default", "split3"])
def test_chain_schedule_runs_the_full_product(w, precision):
    """Every step runs W/16 x 16 x passes x k-steps tensor-core
    instructions: no algebraic reduction of the product."""
    mat, feat = bench_dot.chain_inputs(w, "cpu")
    _, _, count = _chain_model(mat, feat, precision, 1)
    passes = 1 if precision == "default" else 3
    assert count == w // 16 * 16 * passes * K_STEPS[precision]


@pytest.mark.parametrize("precision", ["highest", "default", "split3"])
def test_chain_sign_flip_is_the_split_of_the_flipped_features(precision):
    """Flipping the signs of feat's hi and lo parts gives the parts of
    where(feat > a00, feat, -feat), bit for bit (both roundings are
    symmetric; a lo part of 0 may come out as -0, which adds as 0), at
    thresholds that flip none, some and all."""
    _, feat = bench_dot.chain_inputs(16, "cpu")
    f0 = feat.numpy()
    split = _parts(f0, precision)
    for a00 in (-1e9, 0.0, 0.37, 1e9):
        sign = np.where(f0 > a00, 1.0, -1.0)
        want = _parts(np.where(f0 > a00, f0, -f0), precision)
        for got, ref in zip(split, want):
            assert np.array_equal((got * sign).astype(F32), ref.astype(F32))


# ---------------------------------------------------------------------------
# T2: the walk loop


@pytest.fixture(scope="module")
def soup():
    """A 512-triangle soup, its tree in both packages (bit-equal tables),
    and one packet of 2048 rays from a corner into it."""
    from glaze_tpu.accel.bvh import build_bvh as jax_build

    from glaze_tpu_torch.accel.bvh import build_bvh

    rng = np.random.default_rng(41)
    base = rng.uniform(-4, 4, (512, 1, 3))
    tri = (base + rng.uniform(-0.5, 0.5, (512, 3, 3))).astype(np.float32)
    jb, _ = jax_build(tri)
    pb, _ = build_bvh(tri, "cpu")
    o = np.tile(np.asarray([[-6.0, -5.0, -7.0]], np.float32), (2048, 1))
    o += rng.uniform(-0.3, 0.3, o.shape).astype(np.float32)
    d = rng.uniform(-4, 4, (2048, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jb, pb, o, d


def test_soup_tables_bit_equal(soup):
    jb, pb, _, _ = soup
    assert pb.n_nodes == jb.n_nodes
    for name in ("nodes16", "tri8", "nodes"):
        j = np.asarray(getattr(jb, name)).view(np.int32)
        p = getattr(pb, name).numpy().view(np.int32)
        assert np.array_equal(j, p), name


def _tool_walk(jb, o, d, variant, monkeypatch):
    monkeypatch.setenv("GLAZE_XLA_CACHE", "0")  # the tool enables the cache
    from glaze_tpu.accel.traverse_pallas import (LANES, PACKET_ROWS, _hbm,
                                                 _ray_blk, _table_scratch)
    from tools import exp_overhead as tool

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(1,),
        in_specs=[_hbm(jb.nodes16), _hbm(jb.tri8)]
        + [_ray_blk() for _ in range(6)],
        out_specs=_ray_blk(),
        scratch_shapes=_table_scratch(jb.nodes16, jb.tri8))
    call = pl.pallas_call(
        tool.make_kernel(variant, jb.n_nodes), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((PACKET_ROWS, LANES), jnp.float32),
        interpret=True)
    comps = [jnp.asarray(a[:, i].reshape(PACKET_ROWS, LANES))
             for a in (o, d) for i in range(3)]
    out = call(jnp.zeros((1,), jnp.int32), jb.nodes16, jb.tri8, *comps)
    return np.asarray(out).reshape(-1)


def _port_walk(pb, o, d, variant, packet, stats=None):
    o3 = tuple(torch.from_numpy(o[:, i].copy()) for i in range(3))
    d3 = tuple(torch.from_numpy(d[:, i].copy()) for i in range(3))
    if stats is not None:
        return exp_overhead.walk_overhead_plain(pb, o3, d3, variant, packet,
                                                stats)
    return exp_overhead.walk_overhead(pb, o3, d3, variant, packet)


@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
def test_walk_matches_tool_kernel(soup, variant, monkeypatch):
    jb, pb, o, d = soup
    want = _tool_walk(jb, o, d, variant, monkeypatch)
    stats = {}
    t, iters = _port_walk(pb, o, d, variant, 2048, stats)
    t = t.numpy()
    assert iters.shape == (1,) and int(iters[0]) > 10
    if variant == "A":
        assert (want > 0).sum() >= 64
        assert np.array_equal(t > 0, want > 0)
        rel = np.abs(t - want) / np.maximum(want, 1e-6)
        assert rel.max() <= T_RTOL, rel.max()
    else:
        assert np.array_equal(t, want)
    if variant == "B":  # +1 per leaf entered: the leaf bodies, every ray
        assert np.all(t == float(stats["leaf_bodies"][0]))
    if variant == "D":
        assert int(iters[0]) == exp_overhead.d_walk_length(pb)


WALK_THREADS, WALK_PER = 256, 8  # a packet-2048 block: threads, rays each


def _leaf_lists_model(acc, hit, tri, o, d, seen):
    """Packet 2048: warp w lists its threads' hitting rays (thread t, slot
    j: ray t + 256 j) in one segment, in thread then slot order; the
    block's threads take the listed rays in turn and each runs its ray's 8
    tests in order k, adding only the hits' t to the ray's sum."""
    listed = [t + WALK_THREADS * j for w in range(WALK_THREADS // 32)
              for t in range(32 * w, 32 * w + 32) for j in range(WALK_PER)
              if hit[t + WALK_THREADS * j]]
    assert sorted(listed) == torch.nonzero(hit).flatten().tolist()
    seen["warps"] = max(seen.get("warps", 0),
                        len({(r % WALK_THREADS) // 32 for r in listed}))
    idx = torch.tensor(listed, dtype=torch.int64)
    t, _, _, h = bvh_intersect(tri[None].expand(len(listed), 8, 9),
                               o[idx][:, None], d[idx][:, None])
    s = acc[idx]
    for k in range(8):
        s = torch.where(h[:, k], s + t[:, k], s)
    acc[idx] = s


def _leaf_pairs_model(acc, hit, tri, o, d, seen):
    """Packet 32: round r gives lane l the pair (hitting ray 4r + l // 8,
    triangle l % 8); the owner of the hitting ray of rank i gathers lanes
    8 (i % 4) + k, k = 0..7, of round i // 4 and adds them in order (a
    miss adds +0)."""
    lanes = torch.arange(32)
    hitting = torch.nonzero(hit).flatten()
    n_hit = hitting.numel()
    seen["rounds"] = max(seen.get("rounds", 0), (n_hit + 3) // 4)
    for rnd in range((n_hit + 3) // 4):
        i = 4 * rnd + lanes // 8
        src = hitting[i.clamp(max=n_hit - 1)]
        t, _, _, h = bvh_intersect(tri[lanes % 8][:, None], o[src][:, None],
                                   d[src][:, None])
        v = torch.where((i < n_hit) & h[:, 0], t[:, 0], torch.zeros(32))
        rank = torch.arange(n_hit)
        own = rank // 4 == rnd
        owners, rank = hitting[own], rank[own]
        for kk in range(8):
            acc[owners] = acc[owners] + v[(rank % 4) * 8 + kk]


def _walk_schedule_model(pb, o, d, variant, packet):
    """walk_overhead_kernel's walk of variants A and B, packet by packet:
    one vote per node; B counts the leaves entered; A runs the leaf tests
    of the rays that hit the leaf box by the kernel's lists (packet 2048)
    or pairs (packet 32). Returns (t, iters, what the schedules saw)."""
    nodes, meta, skip = exp_overhead.octant0_nodes(pb)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    inv = exp_overhead.pallas_inv(d)
    rows = pb.tri[:, :9]
    leaf_body = _leaf_lists_model if packet == 2048 else _leaf_pairs_model
    out = torch.zeros(o.shape[0])
    iters = torch.zeros(o.shape[0] // packet, dtype=torch.int32)
    seen = {}
    for pk in range(iters.numel()):
        sl = slice(pk * packet, (pk + 1) * packet)
        acc = torch.zeros(packet)
        leaves = torch.zeros(())
        ptr = 0
        while ptr < pb.n_nodes:
            iters[pk] += 1
            hit = exp_overhead._slab(nodes[ptr][None], o[sl][None], inv[sl][None])[0]
            is_leaf = int(meta[ptr]) >= 0
            any_hit = bool(hit.any())
            if any_hit and is_leaf:
                if variant == "B":
                    leaves = leaves + 1.0
                else:
                    first = (int(meta[ptr]) >> 3) & ~7
                    leaf_body(acc, hit, rows[first:first + 8], o[sl], d[sl], seen)
            ptr = ptr + 1 if any_hit and not is_leaf else int(skip[ptr])
        out[sl] = leaves if variant == "B" else acc
    return out, iters, seen


@pytest.mark.parametrize("packet", [2048, 32])
@pytest.mark.parametrize("variant", ["A", "B"])
def test_walk_schedule_model_matches_plain(soup, variant, packet):
    """The model of the kernel's leaf lists and pairs against the plain
    walk, bit for bit (packet 32 on the first 512 rays)."""
    _, pb, o, d = soup
    n = 2048 if packet == 2048 else 512
    t, iters, seen = _walk_schedule_model(pb, o[:n], d[:n], variant, packet)
    tp, ip = _port_walk(pb, o[:n], d[:n], variant, packet)
    assert torch.equal(iters, ip)
    assert np.array_equal(t.numpy().view(np.int32), tp.numpy().view(np.int32))
    if variant == "A":
        assert (tp > 0).sum() >= 64
        # lists from several warps; leaves with more than one round of pairs
        key = "warps" if packet == 2048 else "rounds"
        assert seen[key] >= 2, seen


def test_walk_stats_count_the_rays_that_hit_entered_leaves(soup):
    _, pb, o, d = soup
    stats = {}
    _port_walk(pb, o, d, "B", 32, stats)
    assert 0 < stats["leaf_ray_hits"] < int(stats["leaf_bodies"].sum()) * 32
    stats_a = {}
    _port_walk(pb, o, d, "A", 32, stats_a)
    assert stats_a["leaf_ray_hits"] == stats["leaf_ray_hits"]


def test_d_walk_length_is_the_tools_host_loop(soup):
    """The tool's host loop (exp_overhead.py:128-136) on glaze_tpu's tree."""
    jb, pb, _, _ = soup
    skp = np.asarray(jb.nodes[:, 7]).view(np.int32)
    meta = np.asarray(jb.nodes[:, 6]).view(np.int32)
    ptr, d_iters = 0, 0
    while 0 <= ptr < jb.n_nodes:
        d_iters += 1
        ptr = ptr + 1 if (ptr % 3 != 2 and meta[ptr] < 0) else skp[ptr]
    assert exp_overhead.d_walk_length(pb) == d_iters


@pytest.mark.parametrize("variant", ["A", "B", "C"])
def test_walk_packet_vote_is_per_packet(soup, variant):
    """64 copies of one 32-ray group in a 2048-ray packet vote as the
    group does alone in a packet of 32."""
    _, pb, o, d = soup
    idx = np.tile(np.arange(32), 64)
    t_big, it_big = _port_walk(pb, o[idx], d[idx], variant, 2048)
    t_small, it_small = _port_walk(pb, o[:32], d[:32], variant, 32)
    assert int(it_big[0]) == int(it_small[0])
    assert np.array_equal(t_big.numpy()[:32], t_small.numpy())


# ---------------------------------------------------------------------------
# T4: the slab-test rate


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slab_rate_matches_tool_kernel(dtype, monkeypatch):
    from tools import bench_bf16_slab as tool

    monkeypatch.setattr(tool, "ITERS", 24)
    tdt = bench_bf16_slab.DTYPES[dtype]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    o, i, nodes = bench_bf16_slab.slab_inputs(tdt, 16, "cpu")
    to_j = lambda x: jnp.asarray(x.float().numpy()).astype(jdt)  # noqa: E731
    want = pl.pallas_call(
        tool._make_kernel(jdt), out_shape=jax.ShapeDtypeStruct((16, 128), jdt),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )(to_j(o), to_j(i), jnp.asarray(nodes.numpy()))
    got = bench_bf16_slab.slab_rate_probe(o, i, nodes, 24)
    assert got.dtype == tdt
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the kernels, on a card


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 32, 64, 128])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_drain_kernel_matches_plain_on_cuda(T, precision):
    dev = _cuda()
    tri, rays, order = _cloud(T, seed=3)
    mats, centres = bench_mxu.leaf_matrices(tri, T)
    args = (torch.from_numpy(mats.reshape(-1, mats.shape[2])).to(dev),
            torch.from_numpy(centres).to(dev), torch.from_numpy(rays).to(dev),
            torch.from_numpy(order).to(dev), T, precision)
    got = [x.cpu().numpy() for x in bench_mxu.drain_probe(*args)]
    want = [x.cpu().numpy() for x in bench_mxu.drain_probe_plain(*args)]
    _assert_drain_close(got, want, f"T={T} {precision} kernel", KERNEL_UV_ATOL)
    # exact ties: repeated triangles in rows g and g + 8, in two m16 tiles
    # and in two leaves; tri equals the plain drain's on every ray
    tie = bench_mxu.tie_inputs(T)
    args = [torch.from_numpy(tie[k]).to(dev)
            for k in ("mats", "centres", "rays", "order")] + [T, precision]
    got = [x.cpu().numpy() for x in bench_mxu.drain_probe(*args)]
    want = [x.cpu().numpy() for x in bench_mxu.drain_probe_plain(*args)]
    _assert_drain_close(got, want, f"T={T} {precision} ties", KERNEL_UV_ATOL)
    tri = want[1][0]
    assert (tie["tied"][tri[tri >= 0]]).sum() >= 1024


@pytest.mark.cuda
def test_drain_kernels_do_not_spill_on_cuda():
    _cuda()
    attrs = probes_cuda.kernel_attrs()
    assert set(attrs) == set(probes_cuda.ATTR_KERNELS)
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, f"{name} spills"
        assert a["registers"] <= 255 and a["blocks_per_sm"] >= 1
        if name.startswith("walk") and name.endswith("2048"):
            assert a["blocks_per_sm"] >= 2, f"{name}: one packet per SM"


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default", "split3"])
def test_dot_chain_kernel_matches_plain_on_cuda(precision):
    dev = _cuda()
    mat, feat = bench_dot.chain_inputs(512, dev)
    got, tr_k = bench_dot.dot_chain_probe(mat, feat, precision, 6, trace=True)
    want, tr_p = bench_dot.dot_chain_plain(mat, feat, precision, 6, trace=True)
    first, _ = bench_dot.first_flip(feat, tr_k, tr_p)
    if first is not None:
        pytest.skip(f"the feedback flipped on rounding at step {first}")
    err = float((got - want).abs().max())
    assert err <= CHAIN_RTOL * float(want.abs().max())


@pytest.mark.cuda
def test_resolve_chain_kernel_matches_plain_on_cuda():
    dev = _cuda()
    mat, feat = bench_dot.chain_inputs(256, dev)
    got = [x.cpu().numpy() for x in bench_dot.resolve_chain_probe(mat, feat, 64, 4)]
    want = [x.cpu().numpy() for x in bench_dot.as_rows(
        bench_dot.resolve_chain_plain(mat, feat, 64, 4), bench_dot.T_INIT)]
    _assert_drain_close(got, want, "resolve chain kernel", KERNEL_UV_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
@pytest.mark.parametrize("packet", [2048, 32])
def test_walk_kernel_matches_plain_on_cuda(soup, variant, packet):
    dev = _cuda()
    _, pb, o, d = soup
    bvh = pb.to(dev)
    o3 = tuple(torch.from_numpy(o[:, i].copy()).to(dev) for i in range(3))
    d3 = tuple(torch.from_numpy(d[:, i].copy()).to(dev) for i in range(3))
    t, iters = exp_overhead.walk_overhead(bvh, o3, d3, variant, packet)
    tp, ip = exp_overhead.walk_overhead_plain(bvh, o3, d3, variant, packet)
    assert torch.equal(iters, ip)
    assert torch.equal(t, tp)  # --fmad=false: A's sums bit for bit too


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slab_rate_kernel_matches_plain_on_cuda(dtype):
    dev = _cuda()
    o, i, nodes = bench_bf16_slab.slab_inputs(
        bench_bf16_slab.DTYPES[dtype], 32, dev)
    got = bench_bf16_slab.slab_rate_probe(o, i, nodes, 64)
    want = bench_bf16_slab.slab_rate_plain(o, i, nodes, 64)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_slab_rate_bf16_kernel_at_tool_rows_on_cuda():
    """The bf16 kernel at the tool's 256 rows and 2,048 iterations (a full
    node period of 16-row steps each 64 iterations; acc past 256, where a
    bf16 add of 1.0 rounds) and at 77 iterations (a tail of 13): every
    element equals the plain loop's."""
    dev = _cuda()
    o, i, nodes = bench_bf16_slab.slab_inputs(torch.bfloat16, 256, dev)
    for iters in (bench_bf16_slab.ITERS, 77):
        got = bench_bf16_slab.slab_rate_probe(o, i, nodes, iters)
        want = bench_bf16_slab.slab_rate_plain(o, i, nodes, iters)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))



_SASS = """
	code for sm_90a
		Function : _Z13slab_rate_f32PKfS0_S0_iifPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_1:
        /*0020*/                   LDS R4, [R2] ;
        /*0030*/                   FADD R5, R4, -R3 ;
        /*0040*/                   FMUL R6, R5, R7 ;
        /*0050*/                   FMNMX R8, R6, R9, PT ;
        /*0060*/                   FSETP.GTU.AND P0, PT, R8, R6, PT ;
        /*0070*/                   HMNMX2.BF16_V2 R10, R10, R11, PT ;
        /*0080*/                   IADD3 R2, R2, 0x4, RZ ;
        /*0090*/               @P1 BRA `(.L_x_1) ;
        /*00a0*/                   BRA `(.L_x_2) ;
.L_x_2:
        /*00b0*/                   STG.E [R12.64], R8 ;
        /*00c0*/                   EXIT ;
		Function : _Z5otherv
        /*0000*/                   EXIT ;
"""


def _sass_loops():
    """scripts/sass_loops.py, which is a script beside the package."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "sass_loops.py")
    spec = importlib.util.spec_from_file_location("sass_loops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sass_loops_reads_a_listing():
    """The SASS loop counter finds the backward branch, and only it, and
    classes the loop's instructions (the kernels' listings come from the
    card's toolkit; this is a listing in its format)."""
    sl = _sass_loops()

    funcs = sl.functions(_SASS)
    assert sorted(funcs) == ["_Z13slab_rate_f32PKfS0_S0_iifPf", "_Z5otherv"]
    insns, found = sl.loops(funcs["_Z13slab_rate_f32PKfS0_S0_iifPf"])
    assert len(insns) == 13 and found == [(2, 9)]
    s = sl.summarize(insns, *found[0])
    assert s["instructions"] == 8
    assert s["classes"] == {"bf16x2_minmax": 1, "control": 1, "f32_add": 1,
                            "f32_compare": 1, "f32_minmax": 1, "f32_mul": 1,
                            "int": 1, "shared": 1}
    assert s["float_ops"] == 5


# ---------------------------------------------------------------------------
# the bounds' instruction classes and rates


def _script(name):
    """A script beside the package (scripts/<name>.py) or chip_smoke.py."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = (os.path.join(root, f"{name}.py") if name == "chip_smoke"
            else os.path.join(root, "scripts", f"{name}.py"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_class_counts_sum_to_the_loop_totals():
    """The per-class splits of the bounds' counts add up to the totals the
    SASS counter printed: 25 a node visit, 59 a triangle test, 12 a cell
    lookup, 51 a fat-leaf column, 27 a T4 f32 test; a T4 bf16 pair issues
    24 packed instructions (one fewer than the 25 of the loop before its
    redesign: the compares are masks, no product makes the hit 1.0) and 2
    LOP3."""
    cs = _script("chip_smoke")
    from glaze_tpu_torch.tools import common

    totals = {"NODE_OPS": 25, "TRI_OPS": 59, "MASK_OPS": 12,
              "COLUMN_OPS": 51}
    for name, total in totals.items():
        ops = getattr(cs, name)
        assert sum(ops.values()) == total, name
        assert set(ops) <= set(common.RATES) | {"other"}, name
    assert sum(bench_bf16_slab.TEST_OPS_F32.values()) == 27
    bf16 = dict(bench_bf16_slab.TEST_OPS_BF16)
    assert bf16.pop("LOP3") == 2 and sum(bf16.values()) == 24
    for ops in (bench_bf16_slab.TEST_OPS_F32, bench_bf16_slab.TEST_OPS_BF16):
        assert set(ops) <= set(common.RATES)


@pytest.mark.parametrize("counts, want", [
    # issue-bound: 256 instructions at 128 a clock; the pipes take 1 and 2
    ({"FADD": 128, "FMNMX": 128}, (2.0, "issue")),
    # one pipe's classes share it: 96 + 96 at 64 a clock
    ({"FMNMX": 96, "FSETP": 96}, (3.0, "alu")),
    # an unrated class counts towards the issue term only
    ({"other": 512, "FMNMX": 64}, (4.5, "issue")),
    ({"MUFU": 64, "FADD": 64}, (4.0, "sfu")),
])
def test_ops_clocks_is_the_largest_term(counts, want, monkeypatch):
    from glaze_tpu_torch.tools import common

    monkeypatch.setattr(common, "RATES", {
        "FADD": ("fma", 128), "FMNMX": ("alu", 64), "FSETP": ("alu", 64),
        "MUFU": ("sfu", 16)})
    clocks, term = common.ops_clocks(counts)
    assert (clocks, term) == want


def test_ops_ms_scales_to_the_blocks(monkeypatch):
    """chip_smoke's ops_ms: SM-clocks over the SMs the blocks occupy."""
    cs = _script("chip_smoke")
    monkeypatch.setattr(cs, "SM_HZ", 1e9)
    ms, term = cs.ops_ms({"FADD": 128 * 132 * 1000})
    assert term == "issue" and ms == pytest.approx(1e-3)
    ms, _ = cs.ops_ms({"FADD": 128 * 1000}, blocks=1)
    assert ms == pytest.approx(1e-3)


def test_issue_rates_helpers():
    """scripts/issue_rates.py on the CPU: the architectural class nearest a
    rate, the rate the charged pipes allow a mixed loop, and the SASS check
    on a listing in cuobjdump's format."""
    ir = _script("issue_rates")
    assert [ir.arch_class(r) for r in (127.0, 90.0, 60.2, 33.0, 15.1)] == [
        128, 64, 64, 32, 16]
    assert ir.model_rate({"FADD": 128}) == 128
    lines = ["\tcode for sm_90a", "\t\tFunction : rate_fadd",
             "        /*0000*/                   MOV R1, c[0x0][0x28] ;",
             ".L_x_0:"]
    addr = 0x10
    for k in range(128):
        lines.append(f"        /*{addr:04x}*/                   FADD R{k % 8}, "
                     f"R{k % 8}, R9 ;")
        addr += 0x10
    lines += [f"        /*{addr:04x}*/                   IADD3 R10, R10, 0x1, RZ ;",
              f"        /*{addr + 0x10:04x}*/              @P0 BRA `(.L_x_0) ;",
              f"        /*{addr + 0x20:04x}*/                   EXIT ;"]
    check = ir.sass_check("\n".join(lines))
    assert check["rate_fadd"]["ok"]
    assert check["rate_fadd"]["FADD"] == 128 and check["rate_fadd"]["loop"] == 130
    assert not check["rate_fmul"]["ok"]
