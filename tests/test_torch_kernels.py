"""The kernels of repro_torch against the reference's Pallas kernels:
the simulator-step kernels here, the mask+GEMM kernels further down.

On the CPU the port's wrappers run the kernels' plain versions; those are
held against ``repro.kernels.sim_step`` run through the Pallas
interpreter inside ``jax.enable_x64(True)`` (float64 survives there).
Shapes exercise a partial last dest tile (W=300), a router count that is
no multiple of the block (N=130) and masks with dead tiles.

Tolerances: float64 at rtol 1e-12 and float32 at rtol 1e-6 of the
output's max (the two sides sum in different orders).  The decision is a
threshold test, so outputs must be identical wherever the two sides of
the inequality differ by more than 1e-9 (float64) or 1e-5 (float32) of
their scale; a rounding can flip a comparison only inside that band.

The CUDA kernels themselves are checked against the plain versions by
the ``cuda``-marked tests, which skip without a card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import sim_step as K
from repro_torch.kernels.ref import fused_decision_ref, fused_step_update_ref

N, KS, W = 130, 5, 300


def _update_inputs(seed, dtype, n=N, k=KS, w=W, dead=(1,)):
    rng = np.random.default_rng(seed)
    q = rng.random((n, k, w))
    split = rng.random((n, k, w))
    deliver = (rng.random((n, k, w)) < 0.05).astype(np.float64)
    fac, corr = rng.random((n, k)), rng.random((n, k))
    inflow = rng.random((n, w))
    mask = np.ones(K.n_tiles(w), dtype=np.int32)
    mask[list(dead)] = 0
    arrs = [a.astype(dtype) for a in (q, split, deliver, fac, corr, inflow)]
    return arrs, mask


def _decision_inputs(seed, dtype, n=N, k=KS, c=W, dead=(0,)):
    rng = np.random.default_rng(seed)
    b0 = rng.random((n, k)) * (rng.random((n, k)) < 0.6)
    split = rng.random((n, k, c)) / k
    dist = rng.integers(1, 4, (n, c)).astype(np.float64)
    hval = 2.0 + rng.random((n, c)) * 3.0
    cand = rng.random((n, c))
    q_val = rng.random(n) * 0.5
    mask = np.ones(K.n_tiles(c), dtype=np.int32)
    mask[list(dead)] = 0
    arrs = [a.astype(dtype) for a in (b0, split, dist, hval, cand, q_val)]
    return arrs, mask


def _reference_kernels():
    # imported here so that the cuda-marked test also collects on a
    # machine whose environment has no jax
    jax = pytest.importorskip("jax")
    from repro.kernels import sim_step
    return jax, sim_step


def _jax_update(arrs, mask):
    jax, ref = _reference_kernels()
    with jax.enable_x64(True):
        q_out, o_out = ref.fused_step_update(*arrs, mask, interpret=True)
        return np.asarray(q_out), np.asarray(o_out)


def _jax_decision(arrs, mask, thr):
    jax, ref = _reference_kernels()
    with jax.enable_x64(True):
        return np.asarray(ref.fused_decision(*arrs, mask, thr=thr,
                                             interpret=True))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_step_update_plain_matches_pallas(dtype, rtol):
    arrs, mask = _update_inputs(0, dtype)
    want_q, want_o = _jax_update(arrs, mask)
    got_q, got_o = fused_step_update_ref(*_t(arrs), torch.from_numpy(mask))
    assert got_q.dtype == torch.from_numpy(arrs[0]).dtype
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=0,
                               atol=rtol * np.abs(want_q).max())
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=0,
                               atol=rtol * np.abs(want_o).max())
    # the dead tile (columns 128..255) is written as zeros
    assert not got_q[:, :, 128:256].any()


def _assert_decision_equal(got, want, arrs, thr):
    # float32 sides round at ~6e-8, so their band is 1e-5
    band = 1e-9 if arrs[0].dtype == np.float64 else 1e-5
    b0, split, dist, hval, _cand, q_val = (a.astype(np.float64)
                                           for a in arrs)
    q_min = np.einsum("nk,nkc->nc", b0, split)
    lhs, rhs = dist * q_min, thr + hval * q_val[:, None]
    scale = max(np.abs(lhs).max(), np.abs(rhs).max())
    clear = np.abs(lhs - rhs) > band * scale
    np.testing.assert_array_equal(got[clear], want[clear])
    assert clear.mean() > 0.99


@pytest.mark.parametrize("thr", [0.0, 16.0])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_decision_plain_matches_pallas(thr, dtype):
    arrs, mask = _decision_inputs(1, dtype)
    if thr == 16.0:      # put the threshold inside the data's range
        arrs[2] = (arrs[2] * 12).astype(dtype)
    want = _jax_decision(arrs, mask, thr)
    got = fused_decision_ref(*_t(arrs), torch.from_numpy(mask), thr).numpy()
    _assert_decision_equal(got, want, arrs, thr)
    assert not got[:, :128].any()             # dead tile
    assert 0 < (want != 0).mean() < 1         # both branches are live


def test_wrappers_route_cpu_tensors_to_plain_versions():
    K.reset_launches()
    arrs, mask = _update_inputs(2, np.float64)
    q_out, o_out = K.fused_step_update(*_t(arrs), torch.from_numpy(mask))
    ref_q, ref_o = fused_step_update_ref(*_t(arrs), torch.from_numpy(mask))
    assert torch.equal(q_out, ref_q) and torch.equal(o_out, ref_o)
    darrs, dmask = _decision_inputs(3, np.float64)
    out = K.fused_decision(*_t(darrs), torch.from_numpy(dmask), 0.0)
    assert torch.equal(out, fused_decision_ref(*_t(darrs),
                                               torch.from_numpy(dmask), 0.0))
    # only launches on the card count
    assert K.LAUNCHES == {"fused_step_update": 0, "fused_decision": 0}


def test_wrappers_reject_bad_inputs():
    arrs, mask = _update_inputs(4, np.float64)
    t = _t(arrs)
    m = torch.from_numpy(mask)
    with pytest.raises(ValueError, match="shape"):
        K.fused_step_update(t[0], t[1][:, :, :10], *t[2:], m)
    with pytest.raises(TypeError, match="dtype"):
        K.fused_step_update(t[0], t[1].float(), *t[2:], m)
    with pytest.raises(TypeError, match="int32"):
        K.fused_step_update(*t, m.long())
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_step_update(t[0].transpose(0, 1).contiguous()
                            .transpose(0, 1), *t[1:], m)
    with pytest.raises(TypeError, match="float32 or float64"):
        K.fused_step_update(*(x.half() for x in t), m)
    darrs, dmask = _decision_inputs(5, np.float64)
    with pytest.raises(ValueError, match="tile_mask"):
        K.fused_decision(*_t(darrs), torch.ones(1, dtype=torch.int32), 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernels_match_plain_versions(dtype):
    """Each CUDA kernel against its plain version on the card: float64 at
    rtol 1e-12, float32 at rtol 1e-5 of the max; the decision identical
    wherever the comparison is clear of rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels cannot run "
                    "on the CPU")
    npdt = np.float64 if dtype == torch.float64 else np.float32
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    arrs, mask = _update_inputs(6, npdt)
    dev = [torch.from_numpy(a).cuda() for a in arrs]
    m = torch.from_numpy(mask).cuda()
    before = dict(K.LAUNCHES)
    q_out, o_out = K.fused_step_update(*dev, m)
    ref_q, ref_o = fused_step_update_ref(*dev, m)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_step_update"] == \
        before["fused_step_update"] + 1
    assert float((q_out - ref_q).abs().max()) <= \
        rtol * float(ref_q.abs().max())
    assert float((o_out - ref_o).abs().max()) <= \
        rtol * float(ref_o.abs().max())
    for thr in (0.0, 16.0):
        darrs, dmask = _decision_inputs(7, npdt)
        if thr == 16.0:
            darrs[2] = (darrs[2] * 12).astype(npdt)
        ddev = [torch.from_numpy(a).cuda() for a in darrs]
        dm = torch.from_numpy(dmask).cuda()
        got = K.fused_decision(*ddev, dm, thr)
        want = fused_decision_ref(*ddev, dm, thr)
        _assert_decision_equal(got.cpu().numpy(), want.cpu().numpy(),
                               darrs, thr)


# ---------------------------------------------------------------------------
# The mask+GEMM kernels (frontier_step, backward_step)
# ---------------------------------------------------------------------------
#
# Ragged shapes (S = 77, N = 203: neither a multiple of the Pallas block)
# and a random weighted A (degree about 12, integer weights 1..3).  Fronts
# hold integer path counts up to 2^14, so products exceed 2^11 (the
# float32 hazard of a TF32 product) and stay exact below 2^24.
# Tolerances: float64 at rtol 1e-12 and float32 at rtol 1e-6 of the
# output's max (the sums run in different orders); dist' and any_new
# exactly.

from repro_torch.kernels import mask_gemm as MG                 # noqa: E402
from repro_torch.kernels.ref import (backward_step_ref,         # noqa: E402
                                     backward_step_tiled_ref,
                                     dense_from_csc, frontier_step_ref,
                                     frontier_step_tiled_ref,
                                     masked_product_tiled)

MS, MN = 77, 203


def _csc(a):
    """A compressed by column, as the kernels take it."""
    cols, rows = np.nonzero(a.T)
    indptr = np.zeros(a.shape[1] + 1, dtype=np.int32)
    np.add.at(indptr, cols + 1, 1)
    return (np.cumsum(indptr).astype(np.int32), rows.astype(np.int32),
            a[rows, cols])


def _mask_inputs(seed, dtype, lvl=3):
    rng = np.random.default_rng(seed)
    a = ((rng.random((MN, MN)) < 0.06)
         * rng.integers(1, 4, (MN, MN))).astype(np.float64)
    front = (rng.integers(0, 2**14, (MS, MN))
             * (rng.random((MS, MN)) < 0.3)).astype(np.float64)
    dist = rng.integers(-1, lvl, (MS, MN)).astype(np.int32)
    sigma = rng.integers(1, 2**12, (MS, MN)).astype(np.float64)
    delta = rng.random((MS, MN))
    coeff = rng.random((MS, MN)) * (dist == lvl - 1)
    cast = lambda x: x.astype(dtype)                            # noqa: E731
    return dict(a=cast(a), csr=_csc(cast(a)), front=cast(front), dist=dist,
                sigma=cast(sigma), delta=cast(delta), coeff=cast(coeff),
                lvl=lvl)


def _jax_mask_gemm(fn_name, *args, **kw):
    jax = pytest.importorskip("jax")
    from repro.kernels import mask_gemm
    with jax.enable_x64(True):
        out = getattr(mask_gemm, fn_name)(*args, interpret=True, **kw)
        return [np.asarray(o) for o in
                (out if isinstance(out, (tuple, list)) else (out,))]


def _tcsr(csr):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in csr)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
@pytest.mark.parametrize("lvl", [1, 3])
def test_frontier_plain_matches_pallas(dtype, rtol, lvl):
    x = _mask_inputs(10 + lvl, dtype, lvl)
    want = _jax_mask_gemm("frontier_step", x["front"], x["a"], x["dist"],
                          x["sigma"], lvl)
    nxt, dist, sigma, any_new = frontier_step_ref(
        torch.from_numpy(x["front"]), _tcsr(x["csr"]),
        torch.from_numpy(x["dist"]), torch.from_numpy(x["sigma"]), lvl)
    assert nxt.dtype == torch.from_numpy(x["front"]).dtype
    _close(nxt.numpy(), want[0], rtol)
    np.testing.assert_array_equal(dist.numpy(), want[1])
    _close(sigma.numpy(), want[2], rtol)
    assert int(any_new) == int((want[0] > 0).any()) == 1
    assert want[0].max() > 2**11            # above the TF32 hazard


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_backward_plain_matches_pallas(dtype, rtol):
    x = _mask_inputs(20, dtype)
    lvl = x["lvl"] - 2
    want = _jax_mask_gemm("backward_step", x["coeff"], x["a"], x["dist"],
                          x["sigma"], x["delta"], lvl)[0]
    got = backward_step_ref(
        torch.from_numpy(x["coeff"]), _tcsr(x["csr"]),
        torch.from_numpy(x["dist"]), torch.from_numpy(x["sigma"]),
        torch.from_numpy(x["delta"]), lvl)
    _close(got.numpy(), want, rtol)
    untouched = x["dist"] != lvl
    np.testing.assert_array_equal(got.numpy()[untouched],
                                  x["delta"][untouched])


def test_frontier_reports_no_new_vertex():
    x = _mask_inputs(30, np.float64)
    dist = np.zeros_like(x["dist"])          # everything already reached
    out = MG.frontier_step(torch.from_numpy(x["front"]), _tcsr(x["csr"]),
                           torch.from_numpy(dist),
                           torch.from_numpy(x["sigma"]), 4)
    assert int(out[3]) == 0 and not out[0].any()
    assert out[3].dtype == torch.int32 and out[3].dim() == 0


def test_dense_from_csc_rebuilds_the_matrix():
    """A is not symmetric here: the triple must be read by column."""
    x = _mask_inputs(31, np.float64)
    assert not np.array_equal(x["a"], x["a"].T)
    np.testing.assert_array_equal(dense_from_csc(*_tcsr(x["csr"])).numpy(),
                                  x["a"])


def test_kernel_csr_is_the_graph_in_bank_order():
    """The kernels' copy of a graph's adjacency holds each row's
    neighbours dealt round-robin over u mod 16 (each residue's entries in
    arc order), the same matrix as the dense adjacency, and leaves the
    graph's own arc order alone."""
    from repro_torch.core import pn_graph
    from repro_torch.core.graph import (KERNEL_BANKS, adjacency_csr,
                                        adjacency_dense)
    g = pn_graph(5)
    arcs = g.indices.copy()
    csr = adjacency_csr(g, torch.float64, "cpu")
    assert np.array_equal(g.indices, arcs)
    got = csr.indices.numpy()
    for v in range(g.n):
        own = arcs[g.indptr[v]:g.indptr[v + 1]]
        buckets = [list(own[own % KERNEL_BANKS == b])
                   for b in range(KERNEL_BANKS)]
        dealt = []
        while any(buckets):
            for bucket in buckets:
                if bucket:
                    dealt.append(bucket.pop(0))
        assert got[g.indptr[v]:g.indptr[v + 1]].tolist() == dealt
    assert torch.equal(dense_from_csc(*csr),
                       adjacency_dense(g, torch.float64, "cpu"))


def test_mask_wrappers_route_cpu_tensors_to_plain_versions():
    MG.reset_launches()
    x = _mask_inputs(32, np.float64)
    t = {k: torch.from_numpy(v) for k, v in x.items()
         if isinstance(v, np.ndarray)}
    csr = _tcsr(x["csr"])
    got = MG.frontier_step(t["front"], csr, t["dist"], t["sigma"], 3)
    want = frontier_step_ref(t["front"], csr, t["dist"], t["sigma"], 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = MG.backward_step(t["coeff"], csr, t["dist"], t["sigma"],
                           t["delta"], 1)
    assert torch.equal(got, backward_step_ref(t["coeff"], csr, t["dist"],
                                              t["sigma"], t["delta"], 1))
    assert MG.LAUNCHES == {"frontier_step": 0, "backward_step": 0}


def test_mask_wrappers_reject_bad_inputs():
    x = _mask_inputs(33, np.float64)
    t = {k: torch.from_numpy(v) for k, v in x.items()
         if isinstance(v, np.ndarray)}
    csr = _tcsr(x["csr"])
    with pytest.raises(ValueError, match="shape"):
        MG.frontier_step(t["front"], csr, t["dist"][:, :5], t["sigma"], 1)
    with pytest.raises(TypeError, match="int32"):
        MG.frontier_step(t["front"], csr, t["dist"].long(), t["sigma"], 1)
    with pytest.raises(TypeError, match="dtype"):
        MG.backward_step(t["coeff"], csr, t["dist"], t["sigma"].float(),
                         t["delta"], 1)
    with pytest.raises(TypeError, match="float32 or float64"):
        MG.frontier_step(t["front"].half(), csr, t["dist"],
                         t["sigma"].half(), 1)
    with pytest.raises(TypeError, match="int32"):
        MG.frontier_step(t["front"], (csr[0].long(), *csr[1:]), t["dist"],
                         t["sigma"], 1)
    with pytest.raises(ValueError, match="indptr"):
        MG.frontier_step(t["front"], (csr[0][:-1], *csr[1:]), t["dist"],
                         t["sigma"], 1)
    with pytest.raises(ValueError, match="contiguous"):
        MG.backward_step(t["coeff"].t().contiguous().t(), csr, t["dist"],
                         t["sigma"], t["delta"], 1)


# The kernels' tiling, mirrored by ref.masked_product_tiled: chunks of
# the contraction (203 = whole rows; 64 and 37 leave a ragged last chunk;
# 1 is one row of A per chunk) and the outputs that are never summed.

@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
@pytest.mark.parametrize("chunk", [MN, 64, 37, 1])
def test_tiled_mirror_matches_plain_and_pallas(dtype, rtol, chunk):
    """The mirror of the kernels' summation order against the plain
    versions and the Pallas kernels (interpret mode), both steps."""
    x = _mask_inputs(40, dtype)
    t = {k: torch.from_numpy(v) for k, v in x.items()
         if isinstance(v, np.ndarray)}
    csr = _tcsr(x["csr"])
    lvl = x["lvl"]
    got = frontier_step_tiled_ref(t["front"], csr, t["dist"], t["sigma"],
                                  lvl, chunk=chunk)
    plain = frontier_step_ref(t["front"], csr, t["dist"], t["sigma"], lvl)
    pallas = _jax_mask_gemm("frontier_step", x["front"], x["a"], x["dist"],
                            x["sigma"], lvl)
    for want in (plain, pallas):
        want = [np.asarray(w) for w in want]
        _close(got[0].numpy(), want[0], rtol)
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        _close(got[2].numpy(), want[2], rtol)
        assert int(got[3]) == int((want[0] > 0).any()) == 1
    blvl = lvl - 2
    got = backward_step_tiled_ref(t["coeff"], csr, t["dist"], t["sigma"],
                                  t["delta"], blvl, chunk=chunk)
    want = _jax_mask_gemm("backward_step", x["coeff"], x["a"], x["dist"],
                          x["sigma"], x["delta"], blvl)[0]
    _close(got.numpy(), want, rtol)
    _close(got.numpy(), backward_step_ref(t["coeff"], csr, t["dist"],
                                          t["sigma"], t["delta"],
                                          blvl).numpy(), rtol)


@pytest.mark.parametrize("chunk", [MN, 50])
def test_tiled_mirror_exact_on_integer_counts(chunk):
    """Path counts and 0/1..3 weights sum exactly in float64, so every
    chunking gives the plain version's outputs bit for bit."""
    x = _mask_inputs(41, np.float64)
    t = {k: torch.from_numpy(v) for k, v in x.items()
         if isinstance(v, np.ndarray)}
    csr = _tcsr(x["csr"])
    got = frontier_step_tiled_ref(t["front"], csr, t["dist"], t["sigma"], 3,
                                  chunk=chunk)
    want = frontier_step_ref(t["front"], csr, t["dist"], t["sigma"], 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tiled_mirror_sums_only_kept_outputs():
    """The skip rules: an all-reached level sums nothing (nxt zero, no
    new vertex, dist and sigma unchanged); the backward step leaves delta
    as it is wherever dist != lvl; the masked product is zero outside
    the mask and the full product inside it."""
    x = _mask_inputs(42, np.float64)
    t = {k: torch.from_numpy(v) for k, v in x.items()
         if isinstance(v, np.ndarray)}
    csr = _tcsr(x["csr"])
    reached = torch.zeros_like(t["dist"])
    nxt, dist, sigma, any_new = frontier_step_tiled_ref(
        t["front"], csr, reached, t["sigma"], 4, chunk=64)
    assert not nxt.any() and int(any_new) == 0
    assert torch.equal(dist, reached) and torch.equal(sigma, t["sigma"])
    out = backward_step_tiled_ref(t["coeff"], csr, t["dist"], t["sigma"],
                                  t["delta"], 1, chunk=37)
    off = t["dist"] != 1
    assert torch.equal(out[off], t["delta"][off])
    need = t["dist"] < 0
    prod = masked_product_tiled(t["front"], csr, need, chunk=37)
    assert not prod[~need].any()
    full = t["front"] @ dense_from_csc(*csr)
    assert torch.equal(prod[need], full[need])


@pytest.mark.parametrize("s,n,itemsize,want", [
    (756, 8322, 8, (3, 8322, 1)),        # first PN(64) block, float64
    (756, 8322, 4, (6, 8322, 1)),        # the same in float32
    (1514, 1514, 8, (8, 1514, 1)),       # PN(27)
    (37, 30011, 8, (4, 7232, 13)),       # a float64 row does not fit
    (3, 20, 8, (3, 20, 1)),              # fewer rows than a tile
])
def test_plan_tiles_fit_shared_memory(s, n, itemsize, want):
    """The kernels' tiling on an H100's 232,448 bytes per block (less the
    reserve) and 132 SMs: the rows of a block fit its shared memory,
    whole rows where they fit, chunks of whole 32-column groups where
    they do not, column splits only where few row groups leave SMs
    idle."""
    smem = 232448 - MG.SMEM_RESERVE
    rows, chunk, splits = MG.plan(s, n, itemsize, smem, 132)
    assert (rows, chunk, splits) == want
    assert rows in MG.ROW_TILES and rows * chunk * itemsize <= smem
    assert (chunk == n) == (n * itemsize * min(rows, s) <= smem)
    assert chunk == n or chunk % MG.GROUP == 0
    assert 1 <= splits <= -(-n // MG.GROUP)


def test_plan_rejects_what_no_block_holds():
    with pytest.raises(ValueError, match="no row segment"):
        MG.plan(4, 100, 8, 7, 132)
    with pytest.raises(ValueError, match="positive"):
        MG.plan(0, 100, 8, 1024, 132)


def _wide_inputs(seed, dtype, s, n, degree=12):
    """A random weighted A given by column (no dense copy), with ``s``
    rows of level state, for shapes whose rows do not fit a block."""
    rng = np.random.default_rng(seed)
    nnz = n * degree
    cols = np.sort(rng.integers(0, n, nnz))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, cols + 1, 1)
    csr = (np.cumsum(indptr).astype(np.int32),
           rng.integers(0, n, nnz).astype(np.int32),
           rng.integers(1, 4, nnz).astype(dtype))
    dist = rng.integers(-1, 3, (s, n)).astype(np.int32)
    return dict(csr=csr, dist=dist,
                front=((rng.integers(0, 2**14, (s, n))
                        * (rng.random((s, n)) < 0.3)).astype(dtype)),
                sigma=rng.integers(1, 2**12, (s, n)).astype(dtype),
                delta=rng.random((s, n)).astype(dtype),
                coeff=(rng.random((s, n)) * (dist == 2)).astype(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_mask_gemm_matches_plain_versions(dtype):
    """Both mask+GEMM kernels against their plain versions on the card:
    float64 at rtol 1e-12, float32 at rtol 1e-6 of the max; dist' and
    the any-new flag exactly; one launch counted per call; bit for bit
    against the mirror of their summation order (the tiled plain
    versions at the plan's chunk) and against a second launch.  Cases:
    S = 77, N = 203 (no multiple of a row tile or of 32), the same with
    every vertex reached (nothing summed: nxt zero, no new vertex, dist
    and sigma unchanged), and S = 37 rows too long for a block's shared
    memory (N = 30,011 in float64, 58,111 in float32): the chunked
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels cannot run "
                    "on the CPU")
    npdt = np.float64 if dtype == torch.float64 else np.float32
    rtol = 1e-12 if dtype == torch.float64 else 1e-6
    x = _mask_inputs(34, npdt)
    reached = dict(x, dist=np.zeros_like(x["dist"]))
    wide = _wide_inputs(35, npdt, 37, 30011 if npdt == np.float64 else 58111)
    for case, lvl, blvl in ((x, 3, 1), (reached, 4, 0), (wide, 3, 1)):
        t = {k: torch.from_numpy(v).cuda() for k, v in case.items()
             if isinstance(v, np.ndarray)}
        csr = tuple(c.cuda() for c in _tcsr(case["csr"]))
        n = t["front"].shape[1]
        chunk = MG._plan_for(t["front"])[1]
        assert (chunk < n) == (case is wide)
        before = dict(MG.LAUNCHES)
        got = MG.frontier_step(t["front"], csr, t["dist"], t["sigma"], lvl)
        again = MG.frontier_step(t["front"], csr, t["dist"], t["sigma"],
                                 lvl)
        want = frontier_step_ref(t["front"], csr, t["dist"], t["sigma"], lvl)
        mirror = frontier_step_tiled_ref(t["front"], csr, t["dist"],
                                         t["sigma"], lvl, chunk=chunk)
        torch.cuda.synchronize()
        assert MG.LAUNCHES["frontier_step"] == before["frontier_step"] + 2
        for g_, w_ in ((got[0], want[0]), (got[2], want[2])):
            _close(g_.cpu().numpy(), w_.cpu().numpy(), rtol)
        assert torch.equal(got[1], want[1]) and int(got[3]) == int(want[3])
        assert all(torch.equal(a, b) for a, b in zip(got, mirror))
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        if case is reached:
            assert not got[0].any() and int(got[3]) == 0
            assert torch.equal(got[1], t["dist"])
            assert torch.equal(got[2], t["sigma"])
        else:
            assert int(got[3]) == 1
        got = MG.backward_step(t["coeff"], csr, t["dist"], t["sigma"],
                               t["delta"], blvl)
        again = MG.backward_step(t["coeff"], csr, t["dist"], t["sigma"],
                                 t["delta"], blvl)
        want = backward_step_ref(t["coeff"], csr, t["dist"], t["sigma"],
                                 t["delta"], blvl)
        mirror = backward_step_tiled_ref(t["coeff"], csr, t["dist"],
                                         t["sigma"], t["delta"], blvl,
                                         chunk=chunk)
        torch.cuda.synchronize()
        assert MG.LAUNCHES["backward_step"] == before["backward_step"] + 2
        _close(got.cpu().numpy(), want.cpu().numpy(), rtol)
        assert torch.equal(got, mirror) and torch.equal(got, again)
        del t, csr, got, again, want, mirror
        torch.cuda.empty_cache()
