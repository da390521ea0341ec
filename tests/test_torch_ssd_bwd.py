"""The backward of the Mamba-2 SSD chunked scan in repro_torch.

The reference has no backward kernel: it trains the SSD by autodiff of
its jnp chunked path (``repro.kernels.ops.ssd(impl="jnp")``).  The port
differentiates the scan through a kernel of its own
(``csrc/ssd_scan_bwd.cu``) whose plain version, ``ssd_scan_bwd_ref``, is
written by hand from the three phases of ``ssd_scan_chunked_ref``.  On
the CPU the wrapper and the autograd Function run that plain version; it
is held against:

* autograd of ``ssd_scan_chunked_ref``, every leaf within 1e-5 of its
  largest magnitude (float32 on both sides; measured at most 1e-6), with
  and without an initial state and a final-state gradient, with G < H,
  over ``test_torch_ssd.py``'s shapes, ragged lengths and both decays;
* ``jax.grad`` of the reference's jnp path, within 3e-4 of each leaf's
  largest magnitude (the reference's own SSD tolerance; its autodiff of
  a float32 cumsum puts up to 5e-5 into d a_log at a real layer's decay).
  Where the length is no multiple of the chunk the reference takes the
  whole length as one chunk and the port a short last one: the same
  function, decomposed otherwise.

At a real layer's decay with chunk 256 the cumsum within a chunk reaches
the thousands; every gradient stays finite (no exp is formed above the
diagonal).  A repeat gives the same bits, and no kernel launches on the
CPU.  The bf16 kernels take d_state 64, 128 or 256 and a head size that
is a multiple of 64: the wrapper's zero-padding (``pad_bwd``, then
``cut_bwd``) is held here through the plain version, every leaf within
1e-6 of its largest magnitude of the unpadded gradients.  The kernels
themselves are held against the plain version by the ``cuda``-marked
test, which skips without a card: every leaf within 3e-4 (float32
operands) or 2^-7 (bf16) of its largest magnitude, and at the serve decay
d a_log and ddt within 1e-5 in both dtypes (a lost cancellation of M's
row and column sums leaves some 2e-4 of d a_log's size, which 2^-7 would
let pass); the bf16 route also within 1e-5 of ``terms=3``.

``ssd_scan_bwd_ref(terms=3)`` emulates the tensor-core route's products
(each float32 operand as its three exact bf16 terms): from bf16 operands
every leaf lies within 2^-7, and within 1e-5, of the float32 plain
version (measured at most 6e-7).  ``terms=1`` (one bf16 cast of each
float32 operand, a kernel without the split) lies within 2^-7 too
(measured at most 6.3e-3: one cast errs by about 2^-9 of a leaf's size),
so 2^-7 cannot tell the two apart; it misses 1e-5 on at least one leaf
(measured 1e-4 to 6e-3 on every leaf but d d_skip, which no product
reaches).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as SS
from test_torch_ssd import RAGGED, SSD_SHAPES, WIDE_CASES, _inputs

CASES = SSD_SHAPES + RAGGED
NAMES = ("dx", "ddt", "da_log", "db", "dc", "dd_skip", "dstate")
AUTOGRAD_TOL = 1e-5
REFERENCE_TOL = 3e-4
PAD_TOL = 1e-6
# the card's rule for d a_log and ddt at the serve decay, both dtypes
CANCEL_TOL = 1e-5
# the bf16 route's rule against the plain version
BF16_TOL = 2.0 ** -7
# terms=3 against the float32 plain version, which one bf16 cast misses
SPLIT_TOL = 1e-5
# (case, d_state and head size as the bf16 kernels pad them)
PAD_CASES = [((1, 96, 4, 16, 1, 16, 32), (64, 64)),     # reduced mamba2
             ((2, 130, 2, 160, 2, 100, 64), (128, 192)),
             ((1, 64, 2, 320, 1, 320, 32), (384, 384)),   # blocks of 192
             ((1, 70, 2, 300, 2, 520, 64), (640, 384)),
             ((1, 40, 2, 500, 1, 16, 16), (64, 512))]      # blocks of 256
# the serve decay at the model's chunk: cum reaches about -1.5e3
SERVE_CASE = (1, 300, 4, 16, 1, 32, 256)
# the serve decay at chunk 512: cum reaches about -6e3
SERVE_LONG_CASE = (1, 1100, 4, 16, 1, 32, 512)
# a chunk, a d_state and a head size over 256
LONG_CASE = (1, 1024, 2, 320, 1, 320, 512)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU products: torch's thread pool only adds latency here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cotangents(case, seed=9):
    """numpy dy (B, L, H, P), dfinal and an initial state (B, H, N, P)."""
    b, l, h, p, _, n = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, l, h, p), (b, h, n, p), (b, h, n, p))]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _hold(got, want, tol, what, names=NAMES):
    """Every leaf within ``tol`` of its largest magnitude; a leaf that is
    zero throughout (d a_log at L = 1 with no state: a moves no
    difference of the cumsum) exactly."""
    assert len(got) == len(want), what
    for name, g, w in zip(names, got, want):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, f"{what} {name}"
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=f"{what} {name}")


def _plain(arrs, dy, chunk, state=None, dfinal=None):
    out = ref.ssd_scan_bwd_ref(*_t(arrs), torch.from_numpy(dy), chunk=chunk,
                               state=state, dfinal=dfinal)
    return [t for t in out if t is not None]


def _autograd(arrs, dy, chunk, state=None, dfinal=None):
    leaves = [t.requires_grad_() for t in _t(arrs)]
    if state is not None:
        state = state.clone().requires_grad_()
        leaves.append(state)
    y, s = ref.ssd_scan_chunked_ref(*leaves[:6], chunk=chunk, state=state)
    loss = (y * torch.from_numpy(dy)).sum()
    if dfinal is not None:
        loss = loss + (s * dfinal).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("with_dfinal", [False, True],
                         ids=["no_dfinal", "dfinal"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
@pytest.mark.parametrize("decay", ["test", "serve"])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd(case, decay, with_state,
                                         with_dfinal):
    chunk = case[-1]
    arrs = _inputs(case, seed=3, decay=decay)
    dy, df, s0 = _cotangents(case)
    state = torch.from_numpy(s0) if with_state else None
    dfinal = torch.from_numpy(df) if with_dfinal else None
    got = _plain(arrs, dy, chunk, state, dfinal)
    assert len(got) == 6 + with_state
    _hold(got, _autograd(arrs, dy, chunk, state, dfinal), AUTOGRAD_TOL,
          f"{case} {decay}")


@functools.cache
def _reference_grad(with_state: bool):
    """``jax.grad`` of the reference's jnp SSD against a cotangent on y
    and one on the final state, jitted per shape."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    def f(x, dt, a_log, bm, cm, ds, state, dy, dfinal, chunk):
        y, s = jops.ssd(x, dt, a_log, bm, cm, ds, chunk=chunk, impl="jnp",
                        state=state if with_state else None)
        return jnp.sum(y * dy) + jnp.sum(s * dfinal)

    argnums = tuple(range(7 if with_state else 6))
    return jax.jit(jax.grad(f, argnums=argnums), static_argnames=("chunk",))


@pytest.mark.parametrize("decay", ["test", "serve"])
@pytest.mark.parametrize("case,with_state",
                         [(c, True) for c in CASES]
                         + [(c, False) for c in RAGGED])
def test_plain_backward_matches_reference_grad(case, with_state, decay):
    chunk = case[-1]
    arrs = _inputs(case, seed=4, decay=decay)
    dy, df, s0 = _cotangents(case, seed=10)
    want = _reference_grad(with_state)(*arrs, s0, dy, df, chunk=chunk)
    got = _plain(arrs, dy, chunk, torch.from_numpy(s0) if with_state
                 else None, torch.from_numpy(df))
    _hold(got, want, REFERENCE_TOL, f"{case} {decay}")


def test_serve_decay_at_chunk_256_gives_finite_gradients():
    """A real layer's decay (a from -1 to -16, dt near 0.7) over a chunk
    of 256: the cumsum reaches the thousands, and every gradient is
    finite and holds against autograd."""
    arrs = _inputs(SERVE_CASE, seed=6, decay="serve")
    dy, df, s0 = _cotangents(SERVE_CASE, seed=11)
    a = -np.exp(arrs[2].astype(np.float64))
    cum = np.cumsum(arrs[1].astype(np.float64)[0, :256] * a, axis=0)
    assert cum.min() < -1e3
    state, dfinal = torch.from_numpy(s0), torch.from_numpy(df)
    got = _plain(arrs, dy, 256, state, dfinal)
    for name, g in zip(NAMES, got):
        assert torch.isfinite(g).all(), name
    _hold(got, _autograd(arrs, dy, 256, state, dfinal), AUTOGRAD_TOL,
          "serve decay, chunk 256")


def test_serve_decay_at_chunk_512_gives_finite_gradients():
    """The serve decay over chunks of 512 (the cumsum reaches about -6e3;
    a short last chunk): every gradient finite and held against
    autograd."""
    arrs = _inputs(SERVE_LONG_CASE, seed=16, decay="serve")
    dy, df, s0 = _cotangents(SERVE_LONG_CASE, seed=17)
    a = -np.exp(arrs[2].astype(np.float64))
    cum = np.cumsum(arrs[1].astype(np.float64)[0, :512] * a, axis=0)
    assert cum.min() < -5e3
    state, dfinal = torch.from_numpy(s0), torch.from_numpy(df)
    got = _plain(arrs, dy, 512, state, dfinal)
    for name, g in zip(NAMES, got):
        assert torch.isfinite(g).all(), name
    _hold(got, _autograd(arrs, dy, 512, state, dfinal), AUTOGRAD_TOL,
          "serve decay, chunk 512")


def test_plain_backward_long_chunk_wide_state_and_head_matches_reference():
    """Chunk 512, d_state 320 and head size 320, with an initial state
    and a final-state gradient: the plain backward against ``jax.grad``
    of the reference's jnp path, every leaf within REFERENCE_TOL."""
    chunk = LONG_CASE[-1]
    arrs = _inputs(LONG_CASE, seed=18)
    dy, df, s0 = _cotangents(LONG_CASE, seed=19)
    want = _reference_grad(True)(*arrs, s0, dy, df, chunk=chunk)
    got = _plain(arrs, dy, chunk, torch.from_numpy(s0), torch.from_numpy(df))
    _hold(got, want, REFERENCE_TOL, f"{LONG_CASE}")


def test_plain_backward_repeats_bit_for_bit():
    case = RAGGED[1]
    arrs = _inputs(case, seed=7, decay="serve")
    dy, df, s0 = _cotangents(case)
    runs = [_plain(arrs, dy, case[-1], torch.from_numpy(s0),
                   torch.from_numpy(df)) for _ in range(2)]
    for name, a, b in zip(NAMES, *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_runs_the_plain_backward_on_the_cpu(dtype):
    """``ops.ssd`` differentiates through ``SSDScan``: on CPU tensors its
    gradients are the plain backward's, in the operands' dtypes, with no
    kernel launched; an unused final state gives no dfinal, and under
    ``no_grad`` the call saves nothing."""
    case = (1, 96, 6, 8, 2, 16, 32)
    x, dt, a_log, bm, cm, ds = _t(_inputs(case, seed=8, decay="serve"))
    dy, _, s0 = _cotangents(case)
    x, bm, cm = (t.to(dtype) for t in (x, bm, cm))
    state = torch.from_numpy(s0)
    dy_t = torch.from_numpy(dy).to(dtype)
    SS.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (x, dt, a_log, bm, cm, ds,
                                                   state)]
    y, _ = ops.ssd(*leaves[:6], chunk=case[-1], state=leaves[6])
    got = torch.autograd.grad(y, leaves, grad_outputs=dy_t)
    want = SS.ssd_scan_bwd(x, dt, a_log, bm, cm, ds, dy_t, chunk=case[-1],
                           state=state)
    for name, g, w, leaf in zip(NAMES, got, want, leaves):
        assert g.dtype == leaf.dtype, name
        assert torch.equal(g, w.to(leaf.dtype)), name
    assert SS.LAUNCHES == {"ssd_scan": 0, "ssd_scan_bwd": 0}
    with torch.no_grad():
        y, s = ops.ssd(*leaves[:6], chunk=case[-1])
    assert y.grad_fn is None and s.grad_fn is None


@pytest.mark.parametrize("with_dfinal", [False, True],
                         ids=["no_dfinal", "dfinal"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
@pytest.mark.parametrize("case,padded", PAD_CASES)
def test_padding_gives_the_same_gradients(case, padded, with_state,
                                          with_dfinal):
    """The bf16 route's zero-padding of d_state and head size, on CPU
    tensors through the plain version: the gradients of the padded
    operands, cut back, are the gradients of the operands (G 2 in the
    second case)."""
    chunk, n, p = case[-1], case[5], case[3]
    x, dt, a_log, bm, cm, ds = _t(_inputs(case, seed=12, decay="serve"))
    dy, df, s0 = _t(_cotangents(case, seed=13))
    state = s0 if with_state else None
    dfinal = df if with_dfinal else None
    xp, bp, cp, dyp, sp, dfp = SS.pad_bwd(x, bm, cm, dy, state, dfinal)
    assert (bp.shape[3], xp.shape[3]) == padded
    assert cp.shape == bp.shape and dyp.shape == xp.shape
    for t, orig in ((sp, state), (dfp, dfinal)):
        assert (t is None) == (orig is None)
        if t is not None:
            assert t.shape[2:] == padded
            assert torch.equal(t[:, :, :n, :p], orig)
            assert not t[:, :, n:].any() and not t[..., p:].any()
    assert torch.equal(xp[..., :p], x) and not xp[..., p:].any()
    assert torch.equal(bp[..., :n], bm) and not bp[..., n:].any()
    got = SS.cut_bwd(ref.ssd_scan_bwd_ref(xp, dt, a_log, bp, cp, ds, dyp,
                                          chunk=chunk, state=sp,
                                          dfinal=dfp), n, p)
    want = ref.ssd_scan_bwd_ref(x, dt, a_log, bm, cm, ds, dy, chunk=chunk,
                                state=state, dfinal=dfinal)
    assert (got[-1] is None) == (state is None)
    _hold([t for t in got if t is not None],
          [t for t in want if t is not None], PAD_TOL,
          f"{case} padded to {padded}")


def _bf16_operands(case, decay):
    """bf16 x, B, C and dy (float32 dt, a_log, d_skip), with an initial
    state and a final-state gradient, as the bf16 route takes them."""
    x, dt, a_log, bm, cm, ds = _t(_inputs(case, seed=14, decay=decay))
    dy, df, s0 = _t(_cotangents(case, seed=15))
    args = (x.bfloat16(), dt, a_log, bm.bfloat16(), cm.bfloat16(), ds,
            dy.bfloat16())
    return args, dict(chunk=case[-1], state=s0, dfinal=df)


SPLIT_CASES = ([(c, "test") for c in CASES] + [(c, "serve") for c in CASES]
               + [(SERVE_CASE, "serve")])


@pytest.mark.parametrize("case,decay", SPLIT_CASES)
def test_plain_backward_three_term_split_holds(case, decay):
    """``terms=3`` from bf16 operands: every leaf, d a_log included,
    within 2^-7 and within 1e-5 of its largest magnitude of the float32
    plain version, and a repeat bit for bit."""
    args, kw = _bf16_operands(case, decay)
    want = ref.ssd_scan_bwd_ref(*args, **kw)
    got = ref.ssd_scan_bwd_ref(*args, terms=3, **kw)
    again = ref.ssd_scan_bwd_ref(*args, terms=3, **kw)
    what = f"{case} {decay} terms=3"
    _hold(got, want, BF16_TOL, what)
    _hold(got, want, SPLIT_TOL, what)
    for name, a, b in zip(NAMES, got, again):
        assert torch.equal(a, b), f"{what} {name} repeat"


@pytest.mark.parametrize("case,decay", SPLIT_CASES)
def test_plain_backward_one_bf16_cast_misses(case, decay):
    """``terms=1`` (one bf16 cast of each float32 operand) misses 1e-5
    of its largest magnitude on at least one leaf: the rule that holds
    the split holds a kernel that drops it."""
    args, kw = _bf16_operands(case, decay)
    want = ref.ssd_scan_bwd_ref(*args, **kw)
    got = ref.ssd_scan_bwd_ref(*args, terms=1, **kw)
    misses = [name for name, g, w in zip(NAMES, got, want)
              if float((g - w).abs().max()) > SPLIT_TOL
              * float(w.abs().max())]
    assert misses, f"{case} {decay}: terms=1 held every leaf"


def test_backward_raises_on_another_device():
    case = RAGGED[0]
    arrs = [t.to("meta") for t in _t(_inputs(case))]
    dy = torch.empty(arrs[0].shape, device="meta")
    with pytest.raises(ValueError, match="no ssd_scan_bwd kernel"):
        SS.ssd_scan_bwd(*arrs, dy, chunk=case[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_scan_bwd_matches_plain_version(dtype):
    """On the card: the backward kernel against its plain version over
    the shape lists, ragged lengths, the serve shape, d_state 256 and a
    head size of 160, with an initial state and a final-state gradient:
    every leaf within 3e-4 (float32 operands) or 2^-7 (bf16) of its
    largest magnitude, d a_log and ddt at the serve decay within 1e-5 in
    both dtypes, bf16 within 1e-5 of ``ssd_scan_bwd_ref(terms=3)``, and
    a repeat bit for bit.  d_state 64, 128 and 256 (and smaller ones
    padded to 64), and WIDE_CASES: chunks of 512 and 1024 (ragged),
    d_state 320, 130 and 256 and head size 320 (blocks of 192)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cases = [(c, "test") for c in CASES] + [(c, "serve") for c in CASES]
    cases += [((1, 1000, 24, 64, 1, 128, 256), "serve"),
              ((1, 300, 4, 64, 1, 256, 128), "serve"),
              ((2, 130, 2, 160, 2, 100, 64), "serve"),
              ((1, 1, 4, 16, 1, 32, 16), "test")] + WIDE_CASES
    tol = 3e-4 if dtype == torch.float32 else 2.0 ** -7
    before = SS.LAUNCHES["ssd_scan_bwd"]
    for case, decay in cases:
        x, dt, a_log, bm, cm, ds = [t.cuda() for t in
                                    _t(_inputs(case, seed=5, decay=decay))]
        dy, df, s0 = [torch.from_numpy(a).cuda() for a in _cotangents(case)]
        args = (x.to(dtype), dt, a_log, bm.to(dtype), cm.to(dtype), ds,
                dy.to(dtype))
        for state, dfinal in ((None, None), (s0, df)):
            got = SS.ssd_scan_bwd(*args, chunk=case[-1], state=state,
                                  dfinal=dfinal)
            again = SS.ssd_scan_bwd(*args, chunk=case[-1], state=state,
                                    dfinal=dfinal)
            torch.cuda.synchronize()
            want = ref.ssd_scan_bwd_ref(*args, chunk=case[-1], state=state,
                                        dfinal=dfinal)
            got, again, want = ([t.cpu() for t in out if t is not None]
                                for out in (got, again, want))
            what = f"{case} {decay} {dtype}"
            _hold(got, want, tol, what)
            if decay == "serve":
                _hold(got[1:3], want[1:3], CANCEL_TOL, what, NAMES[1:3])
            if dtype == torch.bfloat16:
                split = ref.ssd_scan_bwd_ref(*args, chunk=case[-1],
                                             state=state, dfinal=dfinal,
                                             terms=3)
                _hold(got, [t.cpu() for t in split if t is not None],
                      SPLIT_TOL, f"{what} terms=3")
            for name, a, b in zip(NAMES, got, again):
                assert torch.equal(a, b), f"{case} {name} repeat"
    assert SS.LAUNCHES["ssd_scan_bwd"] - before == 4 * len(cases)
