"""The flash-attention backward of repro_torch against the reference.

On the CPU the port's Function runs the kernels' plain versions
(``flash_attention_dq_ref``, ``flash_attention_dkv_ref``); its gradients
are held against ``jax.vjp`` of the reference's Pallas kernels run
through the interpreter (``flash_attention(..., interpret=True,
block_q=64, block_k=64)``, jitted), on the reference's own backward
cases (``tests/test_kernels.py``), a smollm-like GQA case and a D = 16
case, and against torch autograd through the port's oracle
``attention_ref``.

Tolerances: dq, dk, dv within 3e-3 of the Pallas backward in float32
(the reference's own tolerance for its backward), and within 2e-5 as
well, since both sides compute the same float32 sums in another order
(measured differences up to 2.4e-6); the Function against autograd
through the oracle within 1e-4.  On the card the kernels are held
against their plain versions by the ``cuda``-marked test, which skips
without one: float32 within 2e-5, bf16 dq within one bf16 rounding.

The bf16 kernels multiply p and ds on the tensor cores as three bf16
terms (``ref.bf16_split3``); two CPU tests hold that split to what the
kernels rely on: the terms sum back to the float32 value bit for bit, and
three bf16 products summed in float32 give the float32 product.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref

BWD_CASES = [
    # (b, hq, hkv, sq, skv, d, causal, window): the reference's four
    (1, 4, 4, 128, 128, 32, True, None),
    (2, 6, 2, 128, 128, 16, True, None),
    (1, 4, 1, 128, 128, 32, True, 48),
    (1, 2, 2, 128, 256, 32, False, None),
    # smollm-135m's heads (9 q heads over 3 kv heads of 64)
    (1, 9, 3, 128, 128, 64, True, None),
    # a head of 16, zero-padded to 32 on the card
    (1, 4, 2, 64, 64, 16, True, 24),
]
PALLAS_TOL = 3e-3
TIGHT = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU products: torch's thread pool only adds latency here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(case, seed=0):
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                      (b, hq, sq, d))]


@functools.cache
def _pallas_vjp():
    """``(o, dq, dk, dv)`` of the reference's Pallas flash attention in
    interpret mode, jitted (eager jnp costs about a second per call)."""
    import jax
    from repro.kernels.flash_attention import flash_attention

    @functools.partial(jax.jit,
                       static_argnames=("causal", "window", "q_offset"))
    def run(q, k, v, do, causal, window, q_offset=0):
        o, vjp = jax.vjp(lambda q, k, v: flash_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            block_q=64, block_k=64, interpret=True), q, k, v)
        return (o,) + vjp(do)
    return run


def _port_grads(arrs, dtype=torch.float32, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_()
               for a in arrs[:3])
    o = ops.attention(q, k, v, **kw)
    return (o,) + torch.autograd.grad(o, (q, k, v),
                                      torch.from_numpy(arrs[3]).to(dtype))


def _oracle_grads(arrs, **kw):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    o = ref.attention_ref(q, k, v, **kw)
    return (o,) + torch.autograd.grad(o, (q, k, v),
                                      torch.from_numpy(arrs[3]))


@pytest.mark.parametrize("case", BWD_CASES)
def test_function_grads_match_pallas_backward_interpret(case):
    import jax.numpy as jnp
    causal, window = case[6], case[7]
    arrs = _arrays(case)
    want = _pallas_vjp()(*map(jnp.asarray, arrs), causal=causal,
                         window=window)
    got = _port_grads(arrs, causal=causal, window=window)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=PALLAS_TOL, rtol=PALLAS_TOL,
                                   err_msg=f"{name} {case}")
        np.testing.assert_allclose(g, w, atol=TIGHT, rtol=TIGHT,
                                   err_msg=f"{name} {case} (tight)")
    assert all(FA.LAUNCHES[k] == 0 for k in FA.LAUNCHES)   # CPU: no kernel


@pytest.mark.parametrize("case", BWD_CASES + [
    (2, 4, 2, 37, 37, 32, True, 7),          # ragged lengths
    (1, 4, 1, 13, 45, 32, True, None),       # q_offset = skv - sq
    (1, 2, 2, 33, 70, 16, False, None)])
def test_function_grads_match_autograd_through_oracle(case):
    b, hq, hkv, sq, skv, d, causal, window = case
    kw = dict(causal=causal, window=window, q_offset=skv - sq)
    arrs = _arrays(case, seed=1)
    for name, g, w in zip(("o", "dq", "dk", "dv"), _port_grads(arrs, **kw),
                          _oracle_grads(arrs, **kw)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4,
                                   msg=f"{name} {case}")


def test_bf16_grads_are_finite_and_typed():
    """The reference's bf16 case: gradients finite, in the inputs'
    dtype."""
    arrs = _arrays((1, 2, 2, 128, 128, 32), seed=3)
    o, dq, dk, dv = _port_grads(arrs, dtype=torch.bfloat16, causal=True)
    for g in (o, dq, dk, dv):
        assert g.dtype == torch.bfloat16
        assert torch.isfinite(g.float()).all()


def test_dead_rows_get_no_gradient_unlike_the_reference():
    """A query row that sees no key (here: rows 11.. with window 8 and
    q_offset 60 over 64 keys) has o = 0 and lse = -1e30.  The port sets
    p = 0 on masked entries, so such a row gets dq = 0 and adds nothing
    to dk, dv, as autograd through the oracle says.  The reference's
    Pallas backward takes exp(-1e30 - lse) = 1 there and gives those rows
    (and every key) a spurious gradient: the documented difference."""
    import jax.numpy as jnp
    case = (1, 2, 2, 64, 64, 16)
    kw = dict(causal=False, window=8, q_offset=60)
    arrs = _arrays(case, seed=4)
    got = _port_grads(arrs, **kw)
    want = _oracle_grads(arrs, **kw)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4, msg=name)
    dead = slice(11, None)
    assert not got[1][:, :, dead].any()
    pallas = _pallas_vjp()(*map(jnp.asarray, arrs), **kw)
    np.testing.assert_allclose(np.asarray(pallas[0]), got[0].detach(),
                               atol=1e-5)          # forward agrees
    live = slice(0, 11)
    np.testing.assert_allclose(np.asarray(pallas[1])[:, :, live],
                               got[1][:, :, live].detach(), atol=1e-4)
    assert np.abs(np.asarray(pallas[1])[:, :, dead]).max() > 1e-2


def test_zero_padded_heads_keep_the_gradients():
    """What the wrapper does on the card for D < 32: zero columns added
    to q, k, v and dO leave the first D columns of dq, dk, dv as they
    are, and the added columns at 0."""
    arrs = _arrays((1, 4, 2, 40, 40, 16), seed=5)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    kw = dict(causal=True, window=None, q_offset=0, scale=16 ** -0.5)
    o, lse = ref.flash_attention_ref(q, k, v, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    pad = [F.pad(t, (0, 16)) for t in (q, k, v, o, do)]
    got = ref.flash_attention_bwd_ref(*pad[:4], lse, pad[4], **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :16], w, atol=1e-6, rtol=1e-6)
        assert torch.equal(g[..., 16:], torch.zeros_like(g[..., 16:]))


def test_no_grad_attention_is_one_forward():
    """Serving: under no_grad the Function runs the forward alone and
    keeps no graph."""
    arrs = _arrays((1, 4, 2, 32, 32, 32), seed=6)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    with torch.no_grad():
        o = ops.attention(q, k, v)
    assert o.grad_fn is None and not o.requires_grad


def test_backward_wrappers_reject_bad_inputs():
    arrs = _arrays((1, 4, 2, 8, 8, 16))
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    o, lse = FA.flash_attention(q, k, v)
    dsum = (do * o).sum(-1, keepdim=True)
    with pytest.raises(ValueError, match="do must match"):
        FA.flash_attention_dq(q, k, v, do[:, :, :4].contiguous(), lse, dsum)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_dq(q, k, v, do, lse[..., 0], dsum)
    with pytest.raises(ValueError, match="dsum"):
        FA.flash_attention_dkv(q, k, v, do, lse, dsum.double())
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention_dkv(q, k, v,
                               do.transpose(2, 3).contiguous().transpose(2, 3),
                               lse, dsum)


def test_bf16_split3_sums_back_to_the_float32_value_bit_for_bit():
    """hi + mid + lo, summed in float32 (and in float64), is the float32
    input bit for bit, for probabilities in [1e-30, 1] and ds of both
    signs; each term is a bf16 value.  Below 2^-110 (7.7e-34) the lo term
    is a bf16 subnormal and drops the bits under 2^-133: the error seen
    there is at most 2^-133 (9.2e-41)."""
    rng = np.random.default_rng(11)
    n = 100_000
    p = 10.0 ** rng.uniform(-30, 0, n)
    ds = rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-30, 2, n)
    edge = [1.0, 1e-30, -1e-30, 0.0, 2.0 ** -110, 0.99999994, -1.0000001,
            3.4e38]
    for x in (p, ds, np.array(edge)):
        x = torch.from_numpy(x.astype(np.float32))
        hi, mid, lo = ref.bf16_split3(x)
        assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
        assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
        assert torch.equal(hi.double() + mid.double() + lo.double(),
                           x.double())
    tiny = torch.from_numpy((rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(
        -38, -33, n)).astype(np.float32))
    err = (sum(t.double() for t in ref.bf16_split3(tiny))
           - tiny.double()).abs()
    assert err.max() <= 2.0 ** -133
    assert (err[tiny.abs() >= 2.0 ** -110] == 0).all()


def test_three_bf16_products_give_the_float32_product():
    """What the kernels' split products compute: p (softmax rows) and ds
    (both signs), float32, times a bf16 matrix as three bf16 products
    summed in float32 match the float64 product within float32 rounding
    (3 n terms of 2^-24 each); one bf16 cast of p or ds misses it by up
    to 2^-9 of each term."""
    rng = np.random.default_rng(12)
    n = 64
    s = 3.0 * rng.normal(size=(n, n))
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    ds = p * rng.normal(size=(n, n))
    k = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    k = k.bfloat16().float()
    for x in (p, ds):
        x = torch.from_numpy(x.astype(np.float32))
        want = x.double() @ k.double()
        got = torch.zeros(n, n)
        for term in ref.bf16_split3(x):
            got = got + term.float() @ k     # each product exact in float32
        tol = 3 * n * 2.0 ** -24 * (x.double().abs() @ k.double().abs())
        err3 = (got.double() - want).abs()
        err1 = (x.bfloat16().double() @ k.double() - want).abs()
        assert (err3 <= tol).all()
        assert (err1 > tol).any() and err1.max() > 100 * err3.max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernels_match_plain_versions(dtype):
    """On the card: kernel #6 (dq) and #7 (dk, dv per q head) against
    their plain versions over the cases above, ragged lengths that are
    no multiple of the kernels' 64-row and 64-key tiles, a q_offset,
    window edges inside a tile, groups of 1, 3 and 8 q heads per kv
    head, a padded head, heads of 256 (and 192, padded to 256) and
    smollm's shape at S = 1000; bf16 runs the tensor-core kernels,
    float32 the CUDA-core ones (32-row and 32-key tiles at D = 256).
    Both sides compute in float32 from the same inputs: float32 at
    2e-5; bf16 dq within one bf16 rounding (atol 1e-4, rtol 2^-7); dk,
    dv are float32 per q head on both sides (atol 2e-4 + rtol 2e-5 from
    longer sums).  Over all
    cases at least 0.95 of the bf16 dq entries equal the plain float32
    dq rounded to bf16, which one bf16 cast of ds in place of its
    three-way split falls well short of.  A second launch of each kernel
    repeats the first bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    cases = [c + (c[4] - c[3],) for c in BWD_CASES] + [
        (2, 4, 2, 37, 37, 32, True, 7, 0),
        (1, 4, 1, 13, 45, 32, True, None, 32),
        (1, 9, 3, 300, 1300, 64, True, None, 1000),
        (1, 9, 3, 1000, 1000, 64, True, None, 0),
        (1, 4, 2, 130, 130, 128, True, None, 0),
        (1, 3, 3, 97, 150, 64, True, 37, 53),        # group 1
        (1, 8, 1, 200, 200, 64, True, 100, 0),       # group 8
        (1, 6, 2, 129, 129, 128, False, 70, 0),      # group 3
        (2, 8, 8, 45, 77, 32, False, 20, 0),
        (1, 16, 1, 300, 300, 256, True, 128, 0),     # heads of 256
        (2, 4, 2, 100, 180, 256, True, None, 80),
        (1, 4, 4, 97, 150, 192, False, 37, 53)]      # 192, padded
    before = dict(FA.LAUNCHES)
    n = same = total = 0
    for case in cases:
        b, hq, hkv, sq, skv, d, causal, window, off = case
        kw = dict(causal=causal, window=window, q_offset=off)
        q, k, v, do = (torch.from_numpy(a).to(tdt).cuda()
                       for a in _arrays(case, seed=7))
        o, lse = FA.flash_attention(q, k, v, **kw)
        dsum = (do.float() * o.float()).sum(-1, keepdim=True)
        if d in FA.HEAD_DIMS:
            dq = FA.flash_attention_dq(q, k, v, do, lse, dsum, **kw)
            dkh, dvh = FA.flash_attention_dkv(q, k, v, do, lse, dsum, **kw)
            again = (FA.flash_attention_dq(q, k, v, do, lse, dsum, **kw),
                     *FA.flash_attention_dkv(q, k, v, do, lse, dsum, **kw))
            torch.cuda.synchronize()
            n += 2
            for first, second in zip((dq, dkh, dvh), again):
                assert torch.equal(first, second)
            # the plain float32 dq before its cast to q's dtype
            w_dq = ref.flash_attention_dq_ref(
                *(t.float() for t in (q, k, v, do)), lse, dsum, **kw)
            w_dk, w_dv = ref.flash_attention_dkv_ref(q, k, v, do, lse, dsum,
                                                     **kw)
            if tdt == torch.bfloat16:
                torch.testing.assert_close(dq.float(), w_dq.bfloat16().float(),
                                           atol=1e-4, rtol=2.0 ** -7)
                same += int((dq == w_dq.bfloat16()).sum())
                total += dq.numel()
            else:
                torch.testing.assert_close(dq, w_dq, atol=TIGHT, rtol=TIGHT)
            torch.testing.assert_close(dkh, w_dk, atol=2e-4, rtol=2e-5)
            torch.testing.assert_close(dvh, w_dv, atol=2e-4, rtol=2e-5)
        # the whole backward, padding included
        got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        n += 1
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            torch.testing.assert_close(g.float(), w.float(), atol=1e-3,
                                       rtol=2.0 ** -7)
    if tdt == torch.bfloat16:
        assert same / total >= 0.95
    assert FA.LAUNCHES["flash_attention_dq"] == \
        before["flash_attention_dq"] + n
    assert FA.LAUNCHES["flash_attention_dkv"] == \
        before["flash_attention_dkv"] + n
