"""The Mamba-2 SSD chunked scan of repro_torch against the reference.

On the CPU the port's wrapper runs the kernel's plain version
(``ssd_scan_ref``); it is held against the reference's Pallas kernel run
through the interpreter (``ssd_scan``, y only: the kernel emits no
state), its chunked jnp path (``ops.ssd(impl="jnp")``, y and the final
state) and its sequential oracle ``ssd_ref``, over the reference's
``SSD_SHAPES`` (``tests/test_kernels.py``).  A length that is no
multiple of the chunk, which the Pallas kernel cannot take, and the
decay of a real mamba2 layer (a = -1 .. -16 with dt near 0.7, so that
the cumsum within a chunk reaches the thousands) are held against the
oracle.  ``ssd_decode_step`` is held against the reference's.

Tolerance: 3e-4 absolute and relative on y and on the state, the
reference's own (``test_kernels.py``) for the chunked forms against the
sequential recurrence.

The bf16 kernels compute the SSD by its chunk-parallel decomposition
(chunk states, state passing, chunk output); its plain mirror
``ssd_scan_chunked_ref`` is held against ``ssd_scan_ref`` and the Pallas
kernel, and its emulation of the tensor cores' three-way bf16 split
against the plain version, beside one bf16 cast that fails the card's
checks.

A chunk over 256 and a d_state over 256 (chunk 512 over L 1024, d_state
320) are held against the Pallas kernel, the jnp path and the oracle as
above, and at the serve decay against the oracle.  The wrapper's zero
padding (``pad_fwd``: float32 d_state to a multiple of 4, bf16 d_state
and head size to the tensor-core kernels' sizes) gives the unpadded
outputs through the plain version, and so does the float32 kernel's cut
of a d_state over 256 into slices of 256 state rows, whose shares of y
add up to y.

The CUDA kernels themselves are held against the plain version by the
``cuda``-marked test, which skips without a card.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as SS

SSD_SHAPES = [
    # (b, l, h, p, g, n, chunk)
    (2, 64, 4, 16, 1, 32, 16),
    (1, 96, 6, 8, 2, 16, 32),
    (1, 32, 2, 32, 1, 64, 32),
    (2, 128, 8, 16, 4, 8, 64),
]
RAGGED = [(1, 77, 4, 16, 1, 32, 32), (2, 45, 6, 8, 2, 16, 64)]
# a chunk and a d_state over 256
LONG_CASE = (1, 1024, 2, 16, 1, 320, 512)
# the card's new shapes (cuda tests), (case, decay)
WIDE_CASES = [((1, 2048, 24, 64, 1, 128, 512), "serve"),
              ((1, 1100, 4, 64, 1, 128, 1024), "serve"),
              ((1, 600, 4, 64, 1, 320, 256), "serve"),
              ((2, 300, 2, 48, 1, 130, 128), "serve"),
              ((1, 512, 4, 64, 1, 256, 256), "serve"),
              ((1, 512, 2, 320, 1, 64, 256), "serve")]
TOL = 3e-4
# the zero padding through the plain version, of the outputs' largest
# magnitude
PAD_TOL = 1e-6
# the least share of bf16 y entries equal to the plain version's (the
# card's check, chip_smoke.SAME_SHARE)
SAME_SHARE = 0.95


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU products: torch's thread pool only adds latency here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0, decay="test"):
    """numpy inputs as the reference's tests make them; ``decay="serve"``
    uses a mamba2 layer's a_log = log(linspace(1, 16)) and dt ~ 0.7."""
    b, l, h, p, g, n = case[:6]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p))
    if decay == "serve":
        dt = np.log1p(np.exp(rng.normal(size=(b, l, h)) * 0.1))
        a_log = np.log(np.linspace(1.0, 16.0, h))
    else:
        dt = np.abs(rng.normal(size=(b, l, h))) * 0.1 + 0.01
        a_log = rng.normal(size=h) * 0.5
    bm, cm = rng.normal(size=(b, l, g, n)), rng.normal(size=(b, l, g, n))
    ds = rng.normal(size=h)
    return [a.astype(np.float32) for a in (x, dt, a_log, bm, cm, ds)]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@functools.cache
def _reference():
    """The reference's Pallas scan, chunked jnp SSD and oracle, jitted."""
    import jax
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.ssd_scan import ssd_scan
    return (jax.jit(ssd_scan, static_argnames=("chunk", "interpret")),
            jax.jit(jops.ssd, static_argnames=("chunk", "impl")),
            jax.jit(jref.ssd_ref), jops.ssd_decode_step)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=what)


@pytest.mark.parametrize("case", SSD_SHAPES)
def test_ssd_plain_matches_pallas_jnp_and_oracle(case):
    chunk = case[-1]
    arrs = _inputs(case)
    y, s = SS.ssd_scan(*_t(arrs), chunk=chunk)
    assert SS.LAUNCHES["ssd_scan"] == 0           # CPU: no kernel
    pallas, jnp_ssd, oracle, _ = _reference()
    _close(y, pallas(*arrs, chunk=chunk, interpret=True), "y vs Pallas")
    y_j, s_j = jnp_ssd(*arrs, chunk=chunk, impl="jnp")
    _close(y, y_j, "y vs jnp chunked")
    _close(s, s_j, "state vs jnp chunked")
    y_o, s_o = oracle(*arrs)
    _close(y, y_o, "y vs ssd_ref")
    _close(s, s_o, "state vs ssd_ref")


@pytest.mark.parametrize("decay", ["test", "serve"])
@pytest.mark.parametrize("case", RAGGED)
def test_ssd_plain_ragged_and_serve_decay_match_oracle(case, decay):
    arrs = _inputs(case, seed=1, decay=decay)
    y, s = ops.ssd(*_t(arrs), chunk=case[-1])
    y_o, s_o = _reference()[2](*arrs)
    _close(y, y_o, "y vs ssd_ref")
    _close(s, s_o, "state vs ssd_ref")


def test_ssd_initial_state_carries_across_calls():
    """Two halves with the state carried equal one pass, and the
    reference's chunked SSD given the same initial state."""
    case = (1, 64, 4, 16, 1, 32, 16)
    arrs = _inputs(case, seed=2)
    x, dt, a_log, bm, cm, ds = _t(arrs)
    y_all, s_all = SS.ssd_scan(x, dt, a_log, bm, cm, ds, chunk=16)
    y1, s_mid = SS.ssd_scan(x[:, :40].contiguous(), dt[:, :40].contiguous(),
                            a_log, bm[:, :40].contiguous(),
                            cm[:, :40].contiguous(), ds, chunk=16)
    y2, s_end = SS.ssd_scan(x[:, 40:].contiguous(), dt[:, 40:].contiguous(),
                            a_log, bm[:, 40:].contiguous(),
                            cm[:, 40:].contiguous(), ds, chunk=16,
                            state=s_mid)
    _close(torch.cat([y1, y2], 1), y_all, "split y")
    _close(s_end, s_all, "split state")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    half = [a[:, 40:] if a.ndim > 1 else a for a in arrs]
    y_j, s_j = jops.ssd(*half, chunk=8, impl="jnp",
                        state=jnp.asarray(s_mid.numpy()))
    _close(y2, y_j, "y vs jnp with state")
    _close(s_end, s_j, "state vs jnp with state")


@pytest.mark.parametrize("case", [(2, 128, 8, 16, 2, 16, 32),
                                  (1, 96, 6, 8, 2, 16, 32)])
def test_ssd_chunked_mirror_matches_plain_and_pallas(case):
    """The three-phase mirror of the bf16 kernels against the plain
    version and the reference's Pallas kernel (L a multiple of the chunk,
    G = 2)."""
    chunk = case[-1]
    arrs = _inputs(case, seed=6)
    y, s = ref.ssd_scan_chunked_ref(*_t(arrs), chunk=chunk)
    w_y, w_s = ref.ssd_scan_ref(*_t(arrs), chunk=chunk)
    _close(y, w_y, "mirror y vs ssd_scan_ref")
    _close(s, w_s, "mirror state vs ssd_scan_ref")
    _close(y, _reference()[0](*arrs, chunk=chunk, interpret=True),
           "mirror y vs Pallas")


@pytest.mark.parametrize("decay", ["test", "serve"])
@pytest.mark.parametrize("case", [(1, 77, 4, 16, 2, 32, 32),
                                  (2, 45, 6, 8, 2, 16, 16)])
def test_ssd_chunked_mirror_ragged_with_state_matches_plain(case, decay):
    """The mirror with a short last chunk, G = 2 and an initial state
    against the plain version."""
    chunk = case[-1]
    x, dt, a_log, bm, cm, ds = _t(_inputs(case, seed=7, decay=decay))
    s0 = torch.from_numpy(np.random.default_rng(8).normal(
        size=(case[0], case[2], case[5], case[3])).astype(np.float32))
    y, s = ref.ssd_scan_chunked_ref(x, dt, a_log, bm, cm, ds, chunk=chunk,
                                    state=s0)
    w_y, w_s = ref.ssd_scan_ref(x, dt, a_log, bm, cm, ds, chunk=chunk,
                                state=s0)
    _close(y, w_y, "mirror y with state")
    _close(s, w_s, "mirror state with state")


@pytest.mark.parametrize("case", [(1, 200, 4, 16, 2, 32, 64),
                                  (2, 130, 4, 64, 1, 64, 64)])
def test_ssd_split_terms_match_plain_and_one_bf16_cast_does_not(case):
    """What the bf16 kernels' products with a float32 operand (w dt x,
    the scores with dt folded in, S_in) compute: that operand as its three
    bf16 terms, one float32 product each, summed in float32.  From bf16
    x, B, C the state lies within TOL of the plain version's and bf16 y
    equals the plain bf16 y in at least SAME_SHARE of the entries; one
    bf16 cast of those operands misses both (measured about 0.68 of the
    entries and state errors near 1e-2)."""
    chunk = case[-1]
    x, dt, a_log, bm, cm, ds = _t(_inputs(case, seed=9, decay="serve"))
    args = (x.bfloat16(), dt, a_log, bm.bfloat16(), cm.bfloat16(), ds)
    w_y, w_s = ref.ssd_scan_ref(*args, chunk=chunk)
    shares, errs = [], []
    for terms in (3, 1):
        y, s = ref.ssd_scan_chunked_ref(*args, chunk=chunk, terms=terms)
        shares.append(float((y == w_y).float().mean()))
        errs.append(float(((s - w_s).abs()
                           - TOL * (1 + w_s.abs())).max()))
    assert shares[0] >= SAME_SHARE and errs[0] <= 0
    assert shares[1] < SAME_SHARE and errs[1] > 0


def test_ssd_plain_long_chunk_wide_state_matches_reference():
    """Chunk 512 over L 1024 and d_state 320: y against the reference's
    Pallas kernel at that chunk in the interpreter, y and the final state
    against its chunked jnp path and its oracle."""
    chunk = LONG_CASE[-1]
    arrs = _inputs(LONG_CASE, seed=10)
    y, s = SS.ssd_scan(*_t(arrs), chunk=chunk)
    pallas, jnp_ssd, oracle, _ = _reference()
    _close(y, pallas(*arrs, chunk=chunk, interpret=True), "y vs Pallas")
    y_j, s_j = jnp_ssd(*arrs, chunk=chunk, impl="jnp")
    _close(y, y_j, "y vs jnp chunked")
    _close(s, s_j, "state vs jnp chunked")
    y_o, s_o = oracle(*arrs)
    _close(y, y_o, "y vs ssd_ref")
    _close(s, s_o, "state vs ssd_ref")


def test_ssd_plain_long_chunk_serve_decay_matches_oracle():
    """The serve decay over a chunk of 512 (the cumsum within a chunk
    reaches about -6e3), with an initial state, against the oracle."""
    case = (1, 1024, 4, 16, 1, 320, 512)
    arrs = _inputs(case, seed=11, decay="serve")
    a = -np.exp(arrs[2].astype(np.float64))
    assert np.cumsum(arrs[1].astype(np.float64)[0, :512] * a, 0).min() < -5e3
    s0 = np.random.default_rng(12).normal(
        size=(1, 4, 320, 16)).astype(np.float32)
    y, s = SS.ssd_scan(*_t(arrs), chunk=512, state=torch.from_numpy(s0))
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    y_o, s_o = jref.ssd_ref(*arrs, state=jnp.asarray(s0))
    _close(y, y_o, "y vs ssd_ref")
    _close(s, s_o, "state vs ssd_ref")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_padding_gives_the_same_outputs(dtype):
    """The wrapper's zero padding (``pad_fwd``) of d_state 130 (float32:
    to 132; bf16: to 256) and head size 48 (bf16: to 64), with an initial
    state, through the plain version: y and the final state cut back are
    the unpadded operands' within PAD_TOL of their largest magnitude."""
    case = (2, 300, 2, 48, 1, 130, 128)
    x, dt, a_log, bm, cm, ds = _t(_inputs(case, seed=13, decay="serve"))
    x, bm, cm = (t.to(dtype) for t in (x, bm, cm))
    s0 = torch.from_numpy(np.random.default_rng(14).normal(
        size=(2, 2, 130, 48)).astype(np.float32))
    xp, bp, cp, sp = SS.pad_fwd(x, bm, cm, s0)
    padded = (132, 48) if dtype == torch.float32 else (256, 64)
    assert (bp.shape[3], xp.shape[3]) == padded
    assert sp.shape[2:] == padded and cp.shape == bp.shape
    assert torch.equal(sp[:, :, :130, :48], s0) and not sp[:, :, 130:].any()
    assert torch.equal(bp[..., :130], bm) and not bp[..., 130:].any()
    assert torch.equal(xp[..., :48], x) and not xp[..., 48:].any()
    y, s = ref.ssd_scan_ref(xp, dt, a_log, bp, cp, ds, chunk=128, state=sp)
    w_y, w_s = ref.ssd_scan_ref(x, dt, a_log, bm, cm, ds, chunk=128,
                                state=s0)
    for what, got, want in (("y", y[..., :48], w_y),
                            ("state", s[:, :, :130, :48], w_s)):
        got, want = got.double(), want.double()
        assert float((got - want).abs().max()) <= \
            PAD_TOL * float(want.abs().max()), what


def test_ssd_state_slices_add_up():
    """The float32 kernel's cut of a d_state over 256 into slices of 256
    state rows (d_state 520: 256, 256 and 8), through the plain version:
    each slice's scan of its B, C and state rows (d_skip in the first
    only) gives a share of y, the shares added in slice order give y and
    the slices' final states stack to the final state, within TOL."""
    case = (1, 200, 2, 16, 1, 520, 64)
    x, dt, a_log, bm, cm, ds = _t(_inputs(case, seed=15, decay="serve"))
    s0 = torch.from_numpy(np.random.default_rng(16).normal(
        size=(1, 2, 520, 16)).astype(np.float32))
    w_y, w_s = ref.ssd_scan_ref(x, dt, a_log, bm, cm, ds, chunk=64,
                                state=s0)
    y, finals = None, []
    for k0 in range(0, 520, 256):
        cut = slice(k0, k0 + 256)
        y_k, s_k = ref.ssd_scan_ref(
            x, dt, a_log, bm[..., cut].contiguous(),
            cm[..., cut].contiguous(), ds if k0 == 0 else torch.zeros_like(ds),
            chunk=64, state=s0[:, :, cut].contiguous())
        y = y_k if y is None else y + y_k
        finals.append(s_k)
    _close(y, w_y, "y from the slices' shares")
    _close(torch.cat(finals, 2), w_s, "state from the slices")


def test_port_oracle_matches_reference_oracle():
    arrs = _inputs((2, 24, 4, 8, 2, 16), seed=3)
    y, s = ref.ssd_ref(*_t(arrs))
    y_o, s_o = _reference()[2](*arrs)
    _close(y, y_o, "ssd_ref y")
    _close(s, s_o, "ssd_ref state")


def test_ssd_decode_step_matches_reference():
    """Token by token from a zero state: the port's and the reference's
    one-token updates agree with each other and with the oracle."""
    case = (1, 16, 4, 8, 2, 16)
    arrs = _inputs(case, seed=4)
    x, dt, a_log, bm, cm, ds = arrs
    jstep = _reference()[3]
    y_o, _ = ref.ssd_ref(*_t(arrs))
    s = torch.zeros((1, 4, 16, 8))
    s_j = np.zeros((1, 4, 16, 8), np.float32)
    for t in range(case[1]):
        y_t, s = ops.ssd_decode_step(s, *_t([x[:, t], dt[:, t], a_log,
                                             bm[:, t], cm[:, t], ds]))
        y_jt, s_j = jstep(s_j, x[:, t], dt[:, t], a_log, bm[:, t], cm[:, t],
                          ds)
        _close(y_t, y_jt, f"decode y step {t}")
        _close(s, s_j, f"decode state step {t}")
        _close(y_t, y_o[:, t], f"decode y step {t} vs oracle")


def test_ssd_wrapper_rejects_bad_inputs():
    x, dt, a_log, bm, cm, ds = _t(_inputs((1, 8, 2, 4, 1, 4)))
    with pytest.raises(TypeError, match="float32"):
        SS.ssd_scan(x, dt.double(), a_log, bm, cm, ds, chunk=4)
    with pytest.raises(ValueError, match="shape"):
        SS.ssd_scan(x, dt[:, :4], a_log, bm, cm, ds, chunk=4)
    with pytest.raises(ValueError, match="groups"):
        SS.ssd_scan(x, dt, a_log, bm.expand(1, 8, 3, 4).contiguous(),
                    cm.expand(1, 8, 3, 4).contiguous(), ds, chunk=4)
    with pytest.raises(TypeError, match="dtype"):
        SS.ssd_scan(x, dt, a_log, bm.to(torch.bfloat16), cm, ds, chunk=4)
    with pytest.raises(ValueError, match="contiguous"):
        SS.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                    a_log, bm, cm, ds, chunk=4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_scan_matches_plain_version(dtype):
    """On the card: the kernels against their plain version over the
    shape lists, ragged lengths down to L = 1, an initial state, the serve
    shape, d_state 256 and several 64-column blocks of P, and WIDE_CASES:
    chunks of 512 and 1024 (ragged), d_state 320, 130 and 256 (at chunk
    256: the float32 kernel's shared-memory case) and head size 320 (3e-4
    on y and on the final state; bf16 y within one bf16 rounding: atol
    3e-4, rtol 2^-7, and equal to the plain bf16 y in at least SAME_SHARE
    of the entries over all cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cases = [(c, "test") for c in SSD_SHAPES + RAGGED]
    cases.append(((1, 1000, 24, 64, 1, 128, 256), "serve"))
    cases.append(((1, 200, 8, 16, 2, 64, 64), "serve"))
    cases.append(((1, 300, 4, 64, 1, 256, 128), "serve"))
    cases.append(((2, 130, 2, 160, 2, 100, 64), "serve"))
    cases.append(((1, 1, 4, 16, 1, 32, 16), "test"))
    cases.append(((1, 3, 2, 64, 1, 128, 256), "serve"))
    cases += WIDE_CASES
    before = SS.LAUNCHES["ssd_scan"]
    same = total = 0
    for case, decay in cases:
        x, dt, a_log, bm, cm, ds = [t.cuda() for t in
                                    _t(_inputs(case, seed=5, decay=decay))]
        args = (x.to(dtype), dt, a_log, bm.to(dtype), cm.to(dtype), ds)
        state = torch.randn((case[0], case[2], case[5], case[3]),
                            device="cuda")
        for s_in in (None, state):
            y, s = SS.ssd_scan(*args, chunk=case[-1], state=s_in)
            torch.cuda.synchronize()
            w_y, w_s = ref.ssd_scan_ref(*args, chunk=case[-1], state=s_in)
            rtol = TOL if dtype == torch.float32 else 2.0 ** -7
            np.testing.assert_allclose(y.float().cpu(), w_y.float().cpu(),
                                       atol=TOL, rtol=rtol,
                                       err_msg=str(case))
            np.testing.assert_allclose(s.cpu(), w_s.cpu(), atol=TOL,
                                       rtol=TOL, err_msg=str(case))
            if dtype == torch.bfloat16:
                same += int((y == w_y).sum())
                total += y.numel()
    if dtype == torch.bfloat16:
        assert same / total >= SAME_SHARE
    assert SS.LAUNCHES["ssd_scan"] == before + 2 * len(cases)
