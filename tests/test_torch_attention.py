"""The flash-attention forward of repro_torch against the reference.

On the CPU the port's wrapper runs the kernel's plain version
(``flash_attention_ref``); it is held against the reference's Pallas
kernel run through the interpreter (``_fwd``, which also returns the
log-sum-exp) and against the reference's oracle ``attention_ref``, over
the reference's own shape lists (``tests/test_kernels.py``): GQA, MQA,
sliding window, ``q_offset``, non-causal.  Lengths that are no multiple
of a block, which the Pallas kernel cannot take, are held against the
oracle alone.

Tolerances are the reference's (``test_kernels.py``): 3e-5 in float32,
3e-2 in bfloat16 (the output is rounded to bfloat16 on both sides, one
ulp near 4 is 3.1e-2), absolute and relative.  The log-sum-exp is float32
on both sides from the same inputs: 3e-5.

The CUDA kernel itself is held against the plain version by the
``cuda``-marked test, which skips without a card: float32 at 3e-5, bf16
within one bf16 rounding of the same float32 result, and equal to the
plain bf16 o in at least 0.95 of the entries.  The bf16 kernel multiplies
p by V as p's three bf16 terms (``ref.bf16_split3``); a CPU test holds
that emulation to the plain version's o and shows that one bf16 cast of
p fails the same checks.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref

PALLAS_ATTN = [
    # (b, hq, hkv, sq, skv, d, causal, window)
    (1, 2, 1, 64, 64, 32, True, None),
    (1, 4, 2, 128, 128, 32, True, 64),
    (2, 2, 2, 64, 64, 16, False, None),
    (1, 4, 4, 256, 256, 64, True, None),
]
ATTN_SHAPES = [
    (2, 4, 2, 64, 64, 32, True, None),
    (1, 8, 1, 128, 128, 16, True, 32),     # MQA + window
    (2, 4, 4, 32, 96, 32, False, None),    # cross-attn-like
    (1, 2, 2, 16, 64, 8, True, None),      # decode-ish offset
    (1, 6, 3, 96, 96, 64, True, 48),
]
RAGGED = [
    (1, 9, 3, 37, 37, 64, True, None, 0),
    (2, 4, 2, 50, 50, 32, True, 7, 0),
    (1, 4, 1, 13, 45, 32, True, None, 32),     # q_offset = skv - sq
    (1, 2, 2, 33, 70, 16, False, None, 0),
    (1, 4, 2, 1, 100, 32, True, 24, 99),       # one decode row
]
TOL = {"float32": 3e-5, "bfloat16": 3e-2}
# the least share of bf16 o entries equal to the plain version's (the
# card's check, chip_smoke.SAME_SHARE)
SAME_SHARE = 0.95


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU products: torch's thread pool only adds latency here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, dtype, seed=0):
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return arrs, [torch.from_numpy(a).to(tdt) for a in arrs]


def _jax(arrs, dtype):
    jnp = pytest.importorskip("jax.numpy")
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return [jnp.asarray(a, jdt) for a in arrs]


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _close(got, want, tol, what, rtol=None):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol,
                               rtol=tol if rtol is None else rtol,
                               err_msg=what)


@functools.cache
def _reference():
    """The reference's Pallas forward and oracle, jitted (eager jnp
    dispatch costs about a second per call here)."""
    import jax
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import _fwd
    fwd = jax.jit(_fwd, static_argnames=(
        "causal", "window", "q_offset", "scale", "block_q", "block_k",
        "interpret"))
    oracle = jax.jit(jref.attention_ref,
                     static_argnames=("causal", "window", "q_offset"))
    return fwd, oracle


def _pallas(jargs, causal, window, q_offset):
    q = jargs[0]
    sq, skv, d = q.shape[2], jargs[1].shape[2], q.shape[3]
    return _reference()[0](*jargs, causal=causal, window=window,
                           q_offset=q_offset, scale=d ** -0.5,
                           block_q=min(32, sq), block_k=min(32, skv),
                           interpret=True)


def _oracle(jargs, **kw):
    return _reference()[1](*jargs, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PALLAS_ATTN)
def test_flash_plain_matches_pallas_interpret(case, dtype):
    b, hq, hkv, sq, skv, d, causal, window = case
    arrs, (q, k, v) = _inputs(case, dtype)
    jargs = _jax(arrs, dtype)
    o, lse = FA.flash_attention(q, k, v, causal=causal, window=window)
    assert o.dtype == q.dtype and lse.shape == (b, hq, sq, 1)
    assert FA.LAUNCHES["flash_attention_fwd"] == 0   # CPU: no kernel
    p_o, p_lse = _pallas(jargs, causal, window, 0)
    _close(o, p_o, TOL[dtype], "o vs Pallas interpret")
    _close(lse, p_lse, 3e-5, "lse vs Pallas interpret")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_SHAPES)
def test_flash_plain_matches_oracle(case, dtype):
    b, hq, hkv, sq, skv, d, causal, window = case
    off = skv - sq
    arrs, (q, k, v) = _inputs(case, dtype)
    o, _ = FA.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=off)
    want = _oracle(_jax(arrs, dtype), causal=causal, window=window,
                   q_offset=off)
    _close(o, want, TOL[dtype], "o vs attention_ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RAGGED)
def test_flash_plain_ragged_lengths_match_oracle(case, dtype):
    b, hq, hkv, sq, skv, d, causal, window, off = case
    arrs, (q, k, v) = _inputs(case, dtype, seed=1)
    o = ops.attention(q, k, v, causal=causal, window=window, q_offset=off)
    want = _oracle(_jax(arrs, dtype), causal=causal, window=window,
                   q_offset=off)
    _close(o, want, TOL[dtype], "ragged o vs attention_ref")


def test_flash_lse_is_logsumexp_and_empty_rows_are_zero():
    """lse = log(sum(exp(s))) on live rows; a row with no live key gets
    o = 0 and lse = -1e30 + log(1e-30), as in the reference kernel."""
    _, (q, k, v) = _inputs((1, 2, 1, 8, 8, 16), "float32", seed=2)
    o, lse = FA.flash_attention(q, k, v, causal=False)
    s = (q * 16 ** -0.5) @ k.transpose(-1, -2)
    torch.testing.assert_close(lse[..., 0], torch.logsumexp(s, -1),
                               atol=3e-5, rtol=3e-5)
    # keys start after every query: nothing is live
    o, lse = ref.flash_attention_ref(q, k[:, :, :4], v[:, :, :4],
                                     causal=True, window=2, q_offset=100)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.all(lse == torch.tensor(-1e30) + np.log(1e-30))


@pytest.mark.parametrize("case", [(2, 4, 2, 16, 24, 8, True, 5, 8),
                                  (1, 2, 1, 6, 6, 4, False, None, 0)])
def test_port_oracle_matches_reference_oracle(case):
    """attention_ref of the port against the reference's, kv_len too."""
    from repro.kernels import ref as jref
    b, hq, hkv, sq, skv, d, causal, window, off = case
    arrs, (q, k, v) = _inputs(case, "float32", seed=3)
    kv_len = np.array([skv - 3, skv][:b], np.int32)
    got = ref.attention_ref(q, k, v, causal=causal, window=window,
                            q_offset=off, kv_len=torch.from_numpy(kv_len))
    want = jref.attention_ref(*_jax(arrs, "float32"), causal=causal,
                              window=window, q_offset=off, kv_len=kv_len)
    _close(got, want, 3e-5, "attention_ref")


@pytest.mark.parametrize("case", [(1, 4, 2, 256, 64), (1, 4, 2, 128, 32),
                                  (2, 2, 1, 200, 128)])
def test_split_pv_matches_plain_and_one_bf16_cast_does_not(case):
    """What the bf16 kernel's P V computes: p as its three bf16 terms, one
    float32 product each against the bf16 V, summed in float32.  From
    bf16 inputs its float32 o lies within the float32 tolerance (3e-5) of
    the plain version's and its bf16 o equals the plain bf16 o in at least
    SAME_SHARE of the entries; p cast to one bf16 misses both (measured
    about 0.64 of the entries and errors up to 2.6e-3)."""
    b, hq, hkv, s, d = case
    _, (q, k, v) = _inputs((b, hq, hkv, s, s, d), "bfloat16", seed=13)
    o, _ = ref.flash_attention_ref(q, k, v)
    f32 = [t.float() for t in (q, k, v)]
    o32, _ = ref.flash_attention_ref(*f32)
    shares, beyond = [], []
    for terms in (3, 1):
        got, _ = ref.flash_attention_ref(q, k, v, p_terms=terms)
        got32, _ = ref.flash_attention_ref(*f32, p_terms=terms)
        shares.append(float((got == o).float().mean()))
        beyond.append(int(((got32 - o32).abs()
                           > TOL["float32"] * (1 + o32.abs())).sum()))
    assert shares[0] >= SAME_SHARE and beyond[0] == 0
    assert shares[1] < SAME_SHARE and beyond[1] > 0


def test_attention_wrapper_rejects_bad_inputs():
    _, (q, k, v) = _inputs((1, 4, 2, 8, 8, 16), "float32")
    with pytest.raises(NotImplementedError, match="kv_len"):
        ops.attention(q, k, v, kv_len=torch.tensor([4]))
    with pytest.raises(ValueError, match="heads"):
        FA.flash_attention(q, k[:, :1].expand(1, 3, 8, 16).contiguous(),
                           v[:, :1].expand(1, 3, 8, 16).contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="differs"):
        FA.flash_attention(q, k.to(torch.bfloat16), v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain_version(dtype):
    """On the card: the kernel against its plain version over the shape
    lists, ragged lengths, the serve shape and heads of 32, 128 and 256
    (and 192, padded to 256), in both dtypes: bf16 on the tensor cores,
    float32 on the CUDA cores (whose tiles change at D = 256).  Both
    compute in float32 from the same inputs: f32 3e-5; bf16 o within one
    bf16 rounding (atol 1e-4, rtol 2^-7), far inside |o|, so a wrong P.V
    shows, and equal to the plain bf16 o in at least SAME_SHARE of the
    entries over all cases, which one bf16 cast of p falls short of.
    Every case launches the kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cases = [c + (c[4] - c[3],) for c in PALLAS_ATTN + ATTN_SHAPES] + RAGGED
    cases.append((1, 9, 3, 1000, 1000, 64, True, None, 0))
    cases.append((1, 4, 2, 40, 40, 128, True, None, 0))
    cases.append((1, 4, 2, 70, 70, 120, True, None, 0))     # padded head
    cases.append((1, 4, 1, 257, 257, 32, True, 64, 0))
    cases.append((1, 4, 2, 300, 300, 128, True, None, 0))
    cases.append((1, 6, 2, 129, 333, 128, False, 70, 204))
    cases.append((1, 16, 1, 300, 300, 256, True, 128, 0))   # heads of 256
    cases.append((2, 4, 2, 100, 180, 256, True, None, 80))
    cases.append((1, 4, 4, 97, 150, 192, False, 37, 53))    # 192 padded
    before = FA.LAUNCHES["flash_attention_fwd"]
    same = total = 0
    for case in cases:
        b, hq, hkv, sq, skv, d, causal, window, off = case
        _, args = _inputs(case, dtype, seed=4)
        dev = [a.cuda() for a in args]
        o, lse = FA.flash_attention(*dev, causal=causal, window=window,
                                    q_offset=off)
        torch.cuda.synchronize()
        w_o, w_lse = ref.flash_attention_ref(*dev, causal=causal,
                                             window=window, q_offset=off)
        if dtype == "bfloat16":
            _close(o.cpu(), w_o.cpu(), 1e-4, f"o {case}", rtol=2.0 ** -7)
            same += int((o == w_o).sum())
            total += o.numel()
        else:
            _close(o.cpu(), w_o.cpu(), TOL[dtype], f"o {case}")
        _close(lse.cpu(), w_lse.cpu(), 3e-5, f"lse {case}")
    if dtype == "bfloat16":
        assert same / total >= SAME_SHARE
    assert FA.LAUNCHES["flash_attention_fwd"] == before + len(cases)
