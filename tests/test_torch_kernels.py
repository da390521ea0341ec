"""The simulator-step kernels of repro_torch against the reference's
Pallas kernels.

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
the ``cuda``-marked test, which skips without a card.
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
