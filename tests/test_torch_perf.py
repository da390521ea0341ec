"""The perf flags of repro_torch (``repro_torch.perf``) against the
reference's (``repro.perf``), on the CPU at reduced sizes.

* ``PerfFlags`` has the reference's fields, defaults and order, and
  ``from_env`` parses a ``REPRO_PERF`` line as the reference does;
* the reference's own flag tests (``tests/test_perf_flags.py``) mirrored
  on the port: ``gqa_grouped`` at 2e-2 (in the port bit for bit: its
  kernels index K and V by kv head), ``prob_bf16`` in a prefill and in a
  ragged ``kv_len`` decode at 4e-2;
* the port against the reference under the same flags: attention under
  ``prob_bf16`` against the reference's jnp route
  (``_attention_jnp_blocked``, called eagerly so that it reads the flag
  and no jit cache traced without it is reused), o and the gradients
  (``jax.grad``, the cast passed straight through) within 2^-7 of each
  leaf's largest magnitude; the MLA block's prefill and decode at
  deepseek-v3 ``reduced()`` at the MLA test's 3e-2; ``ssd_chunk`` 16, 64
  and 512 on reduced mamba2 (512 on 1,024 tokens), loss within 1e-3 and
  gradients at the train tests' rule (3e-2 of each leaf's largest
  magnitude, cosine >= 0.9999);
  ``microbatch=4`` on reduced smollm (B 4, S 16, 2 steps): the port's
  loss at mb 1 and mb 4 within rel 2e-4 (the reference's own rule) and
  the port against the reference's microbatched step within 1e-3;
  ``util_engine``, ``util_orbits``, ``util_block``, ``util_dense_max``,
  ``obs`` and ``sim_backend`` as the defaults of calls that name none;
* the mesh-only flags ``bf16_experts`` and ``moe_3d`` change no bit on
  one device, in the reference's ``apply_moe`` with no mesh and in the
  port's ``MoE``.

Each test restores both packages' flags (a file runs on one worker).
The kernels' variants for ``prob_bf16`` are held against their plain
versions on the card by the ``cuda``-marked test, which skips here.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs as tobs
from repro_torch import perf as tperf
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.models import loss_fn
from test_torch_train import _close_grads, _leaves

# o and every gradient of attention under prob_bf16, against the
# reference's jnp route: one bf16 rounding of the leaf's largest size
PB_TOL = 2.0 ** -7


def _ref_perf():
    from repro import perf
    return perf


@pytest.fixture(autouse=True)
def _flags_restored():
    """Both packages' flags as they were after each test; one torch
    thread (tiny CPU products)."""
    rperf = _ref_perf()
    saved = (dataclasses.asdict(tperf.flags()),
             dataclasses.asdict(rperf.flags()))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    tperf.set_flags(**saved[0])
    rperf.set_flags(**saved[1])


@contextlib.contextmanager
def both_flags(**kw):
    """``kw`` set in both packages for the block, then as they were."""
    mods = (tperf, _ref_perf())
    old = [{k: getattr(m.flags(), k) for k in kw} for m in mods]
    for m in mods:
        m.set_flags(**kw)
    try:
        yield
    finally:
        for m, o in zip(mods, old):
            m.set_flags(**o)


def _defaults():
    """Both packages' flags back to their defaults."""
    for mod in (tperf, _ref_perf()):
        mod.set_flags(**dataclasses.asdict(mod.PerfFlags()))


# ---------------------------------------------------------------------------
# The flags and their parsing
# ---------------------------------------------------------------------------


def test_fields_and_defaults_are_the_references():
    rperf = _ref_perf()
    mine = [(f.name, f.type, f.default)
            for f in dataclasses.fields(tperf.PerfFlags)]
    theirs = [(f.name, f.type, f.default)
              for f in dataclasses.fields(rperf.PerfFlags)]
    assert mine == theirs


@pytest.mark.parametrize("spec", [
    "", "opt_all", "prob_bf16,gqa_grouped", " prob_bf16 , microbatch=4 ",
    "ssd_chunk=64,moe_3d=0", "util_engine=dense,util_orbits=0,util_block=7",
    "obs=trace,sim_backend=fused", "util_dense_max=512,util_jax_max=1",
    "microbatch=two", "opt_all,bf16_experts=0,zero1"])
def test_from_env_parses_as_the_reference(spec):
    rperf = _ref_perf()
    _defaults()
    got = dataclasses.asdict(tperf.from_env(spec))
    want = dataclasses.asdict(rperf.from_env(spec))
    assert got == want
    assert tperf.non_default() == {
        k: v for k, v in got.items()
        if v != getattr(tperf.PerfFlags(), k)}


@pytest.mark.parametrize("spec", ["bogus", "prob_bf17=1", "opt_all,nope"])
def test_an_unknown_name_raises_keyerror(spec):
    rperf = _ref_perf()
    with pytest.raises(KeyError):
        rperf.from_env(spec)
    with pytest.raises(KeyError):
        tperf.from_env(spec)
    with pytest.raises(KeyError):
        tperf.set_flags(nope=1)


# ---------------------------------------------------------------------------
# Attention: the reference's flag tests mirrored, and the port against the
# reference's jnp route under prob_bf16
# ---------------------------------------------------------------------------


def _qkv(b=2, hq=6, hkv=2, sq=64, skv=64, d=32, seed=0):
    """bf16 q, k, v from one numpy seed, for jax and for torch."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).bfloat16() for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("window", [None, 24])
def test_gqa_grouped_matches_baseline(window):
    """The reference's test on the port: 2e-2; the port's kernels index K
    and V by kv head either way, so the flag changes no bit."""
    _, (q, k, v) = _qkv()
    base = ops.attention(q, k, v, causal=True, window=window)
    tperf.set_flags(gqa_grouped=True)
    opt = ops.attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(_f32(base), _f32(opt), atol=2e-2, rtol=2e-2)
    assert torch.equal(base, opt)


def test_prob_bf16_close_to_baseline():
    """The reference's test on the port: the kernels' plain versions with
    and without the flag, 4e-2; and the flag does change o."""
    _, (q, k, v) = _qkv(seed=1)
    base = ops.attention(q, k, v, causal=True)
    tperf.set_flags(prob_bf16=True, gqa_grouped=True)
    opt = ops.attention(q, k, v, causal=True)
    np.testing.assert_allclose(_f32(base), _f32(opt), atol=4e-2, rtol=4e-2)
    assert not torch.equal(base, opt)


def test_prob_bf16_with_kv_len_ragged_decode():
    """The reference's test on the port's decode attention (plain torch,
    as the MLA decode attends): 4e-2."""
    _, (q, k, v) = _qkv(b=3, sq=1, skv=40, seed=2)
    kv_len = torch.tensor([5, 17, 40])
    base = ref.attention_ref(q, k, v, causal=False, kv_len=kv_len)
    opt = ref.attention_prob_bf16_ref(q, k, v, causal=False,
                                      kv_len=kv_len)[0]
    np.testing.assert_allclose(_f32(base), _f32(opt), atol=4e-2, rtol=4e-2)


ATTN_CASES = [  # (b, hq, hkv, sq, skv, d, causal, window)
    (2, 6, 2, 64, 64, 32, True, None),
    (2, 6, 2, 64, 64, 32, True, 24),
    (1, 4, 1, 48, 48, 64, True, None),
    (2, 4, 4, 32, 96, 32, False, None),
    (1, 2, 2, 40, 40, 16, True, 9),
]


def _reference_jnp(q, k, v, causal, window, block_q=1024):
    """The reference's jnp route, eagerly (it reads the flags as it runs),
    at its default query block (the whole of these lengths).  Its
    gradients are bf16 sums: the cotangent of the closed-over K and V
    adds up over query blocks and over the repeated heads in bf16, so
    smaller blocks put more roundings into dk and dv."""
    from repro.kernels.ops import _attention_jnp_blocked
    return _attention_jnp_blocked(q, k, v, causal=causal, window=window,
                                  q_offset=0, kv_len=None, scale=None,
                                  block_q=block_q)


def _within(got, want, what, tol=PB_TOL):
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_under_prob_bf16_matches_reference(case):
    """Forward and gradients of the port's attention (the kernels' plain
    versions, and the Function's backward) against the reference's jnp
    route and ``jax.grad`` of it, under the flag on both sides."""
    import jax
    import jax.numpy as jnp
    b, hq, hkv, sq, skv, d, causal, window = case
    (qj, kj, vj), (q, k, v) = _qkv(b, hq, hkv, sq, skv, d, seed=3)
    do = np.random.default_rng(4).normal(size=(b, hq, sq, d))
    do = do.astype(np.float32)
    with both_flags(prob_bf16=True):
        want = _reference_jnp(qj, kj, vj, causal, window)

        def loss(q_, k_, v_):
            o = _reference_jnp(q_, k_, v_, causal, window)
            return jnp.sum(o.astype(jnp.float32) * do)

        wq, wk, wv = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        o = ops.attention(qs, ks, vs, causal=causal, window=window)
        gq, gk, gv = torch.autograd.grad(
            o, (qs, ks, vs), torch.from_numpy(do).bfloat16())
    _within(o, want, "o")
    for name, got, w in (("dq", gq, wq), ("dk", gk, wk), ("dv", gv, wv)):
        assert got.dtype == torch.bfloat16, name
        _within(got, w, name)


def test_prob_bf16_forward_is_the_jnp_routes_one_piece():
    """The plain forward under the flag equals the reference's jnp route
    within one bf16 rounding of o, and float32 operands ignore the flag
    in both packages, bit for bit in the port.  At D = 64 the scale is a
    power of two, q scale is exact in bf16 and lse is the default
    variant's within 1e-5 (at D = 32 the rounding of q scale moves it)."""
    (qj, kj, vj), (q, k, v) = _qkv(d=64, seed=5)
    with both_flags(prob_bf16=True):
        o, lse = FA.flash_attention(q, k, v, prob_bf16=True)
        _within(o, _reference_jnp(qj, kj, vj, True, None, block_q=16),
                "o, blocks of 16 rows")
        qf, kf, vf = (t.float() for t in (q, k, v))
        f_on = ops.attention(qf, kf, vf)
    tperf.set_flags(prob_bf16=False)
    assert torch.equal(f_on, ops.attention(qf, kf, vf))
    # the cast does not touch lse: the same as the default variant's
    _, lse0 = FA.flash_attention(q, k, v)
    torch.testing.assert_close(lse, lse0, atol=1e-5, rtol=0)


def test_prob_bf16_dkv_takes_bf16_p_for_dv_only():
    """The plain dk/dv under the flag: dk as without it, bit for bit; dv
    from p rounded to bf16, within 2^-7 of the float32-p dv and not
    equal to it."""
    _, (q, k, v) = _qkv(seed=6)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(7))
    do = do.bfloat16()
    o, lse = FA.flash_attention(q, k, v, prob_bf16=True)
    dsum = (do.float() * o.float()).sum(-1, keepdim=True)
    dk0, dv0 = FA.flash_attention_dkv(q, k, v, do, lse, dsum)
    dk1, dv1 = FA.flash_attention_dkv(q, k, v, do, lse, dsum,
                                      prob_bf16=True)
    assert torch.equal(dk0, dk1)
    assert not torch.equal(dv0, dv1)
    _within(dv1, dv0, "dv")


# ---------------------------------------------------------------------------
# Models: MLA decode, the SSD chunk, microbatching
# ---------------------------------------------------------------------------


def _arch_reference(name: str, cfg_fn=lambda c: c):
    """(reference cfg, numpy params) of the reduced arch."""
    import jax
    from repro.configs import get_arch as jget
    from repro.models import build as jbuild
    from repro.models import unbox
    cfg = cfg_fn(jget(name).reduced())
    params = unbox(jbuild(cfg).init(jax.random.key(0)))
    return cfg, jax.tree.map(np.asarray, params)


def _x(d, b, s, seed=0):
    import jax.numpy as jnp
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def test_mla_prefill_and_decode_under_prob_bf16():
    """deepseek-v3 reduced's MLA under the flag on both sides: prefill
    (the reference's jnp route; the port's kernel plain version under the
    flag) and two decode steps at different positions against the
    compressed cache (the reference's jnp route with kv_len; the port's
    ``attention_prob_bf16_ref``), y at 3e-2 as the MLA block test; and
    the port's decode does move under the flag."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import apply_mla
    rcfg, npp = _arch_reference("deepseek-v3-671b")
    cfg = get_arch("deepseek-v3-671b").reduced()
    mla = params_from_numpy(cfg, npp, device="cpu").blocks[0].mixer
    p = npp["prefix"][0]["mixer"]
    s, slots = 12, 20
    xj, xt = _x(cfg.d_model, 2, s)
    jax.clear_caches()              # no trace made without the flag
    pos = np.array([[s], [s + 3]], np.int32)
    with both_flags(prob_bf16=True), torch.no_grad():
        yj, cj = apply_mla(rcfg, p, xj, positions=jnp.arange(s),
                           mode="prefill", cache_slots=slots, impl="jnp")
        yt, ct = mla(xt, positions=torch.arange(s), mode="prefill",
                     cache_slots=slots)
        np.testing.assert_allclose(_f32(yt), _f32(yj), atol=3e-2,
                                   rtol=3e-2)
        for step in range(2):
            xj1, xt1 = _x(cfg.d_model, 2, 1, seed=1 + step)
            yj, cj = apply_mla(rcfg, p, xj1,
                               positions=jnp.asarray(pos + step),
                               mode="decode", cache=cj)
            cache0 = {key: t.clone() for key, t in ct.items()}
            yt, ct = mla(xt1, positions=torch.from_numpy(pos + step),
                         mode="decode", cache=ct)
            np.testing.assert_allclose(_f32(yt), _f32(yj), atol=3e-2,
                                       rtol=3e-2, err_msg=f"decode {step}")
    jax.clear_caches()
    with torch.no_grad():
        y0, _ = mla(xt1, positions=torch.from_numpy(pos + 1), mode="decode",
                    cache=cache0)
    assert not torch.equal(y0, yt)


def _grads(cfg, model, tokens):
    loss, _ = loss_fn(cfg, model, {"tokens": torch.from_numpy(tokens)})
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


@pytest.mark.parametrize("chunk", [16, 64, 512])
def test_ssd_chunk_matches_reference(chunk, monkeypatch):
    """Reduced mamba2 (chunk 32 in its config) under ``ssd_chunk``: the
    port's loss and gradients (the SSD kernels' plain versions at that
    chunk) against ``jax.value_and_grad`` of the reference's loss, run
    eagerly under the same flag: loss within 1e-3, gradients at the
    train tests' rule; every scan of the port's step took the flag's
    chunk, and without the flag the config's.  Chunk 512 (over 256)
    runs on 1,024 tokens, so that the scan takes two chunks of it."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import loss_fn as jloss

    def unrolled(c):
        return c.replace(scan_layers=False)

    rcfg, npp = _arch_reference("mamba2-130m", unrolled)
    cfg = unrolled(get_arch("mamba2-130m").reduced())
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64 if chunk <= 64 else 2 * chunk))
    tok = tok.astype(np.int32)
    model = params_from_numpy(cfg, npp, device="cpu")
    chunks = []
    ssd = ops.ssd

    def spy(*args, chunk, **kw):
        chunks.append(chunk)
        return ssd(*args, chunk=chunk, **kw)

    monkeypatch.setattr(ops, "ssd", spy)
    _grads(cfg, model, tok)
    assert set(chunks) == {cfg.ssm.chunk}
    chunks.clear()
    with both_flags(ssd_chunk=chunk):
        (jl, _), jg = jax.value_and_grad(
            lambda p_: jloss(rcfg, p_, {"tokens": jnp.asarray(tok)}),
            has_aux=True)(jax.tree.map(jnp.asarray, npp))
        loss, grads = _grads(cfg, model, tok)
    assert abs(loss - float(jl)) < 1e-3
    assert set(chunks) == {chunk} and len(chunks) >= cfg.n_layers
    _close_grads(_leaves(params_to_numpy(cfg, grads)),
                 _leaves(jax.tree.map(np.asarray, jg)), f"chunk {chunk}")


def _smollm_losses(mb: int, tok, steps: int = 2):
    from repro_torch.train import (TrainStepConfig, make_train_step,
                                   train_state_from_model)
    from test_torch_train import _reference
    cfg = get_arch("smollm-135m").reduced()
    ts = TrainStepConfig()
    state = train_state_from_model(
        cfg, params_from_numpy(cfg, _reference()[2], device="cpu"), ts)
    tperf.set_flags(microbatch=mb)
    step_fn = make_train_step(cfg, "cpu", ts)
    out = []
    for _ in range(steps):
        state, m = step_fn(state, {"tokens": torch.from_numpy(tok)})
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_microbatch_accumulation_matches_reference():
    """Reduced smollm, B 4, S 16, 2 steps: the port at microbatch 1 and 4
    within rel 2e-4 (the reference's own rule), the step's metrics
    averaged over the microbatches; the port at 4 against the
    reference's microbatched step (a (1, 1) host mesh) within 1e-3; and
    B 3, which 4 does not divide, runs the plain step."""
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import make_host_mesh
    from repro.train import TrainStepConfig as JTS
    from repro.train import init_train_state as jinit
    from repro.train import make_train_step as jmake
    from test_torch_train import _reference
    jcfg = _reference()[0]
    tok = np.random.default_rng(1).integers(
        0, jcfg.vocab, (4, 16)).astype(np.int32)
    one = _smollm_losses(1, tok)
    four = _smollm_losses(4, tok)
    assert one[-1]["loss"] == pytest.approx(four[-1]["loss"], rel=2e-4)
    assert one[0]["loss"] == pytest.approx(four[0]["loss"], rel=2e-4)
    assert one[-1]["grad_norm"] == pytest.approx(four[-1]["grad_norm"],
                                                 rel=2e-3)
    with both_flags(microbatch=4):
        jts = JTS()
        jstep, _ = jmake(jcfg, make_host_mesh(1, 1), jts, donate=False)
        jstate = jinit(jcfg, jax.random.key(0), jts)
        for _ in range(2):
            jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
    assert abs(four[-1]["loss"] - float(jm["loss"])) < 1e-3
    odd = _smollm_losses(4, tok[:3], steps=1)
    plain = _smollm_losses(1, tok[:3], steps=1)
    assert odd == plain


def test_microbatch_moe_aux_is_per_microbatch_as_in_reference():
    """granite reduced, B 2, S 16, one step at microbatch 2: the port's
    loss, ce and aux against the reference's microbatched step (run op by
    op, as the train-step parity test runs it) within 1e-3.  The ce is
    microbatch 1's within rel 2e-4 (a mean over tokens); the router's aux
    loss is the mean of the microbatches' own, in both packages, so the
    loss of an MoE config moves with the microbatching."""
    import jax
    from repro.launch.mesh import make_host_mesh
    from repro.optim import adamw_init as jinit
    from repro.train import TrainStepConfig as JTS
    from repro.train import make_train_step as jmake
    from repro.train.train_step import _opt_cfg
    from repro_torch.configs import get_arch as tget
    from repro_torch.train import (TrainStepConfig, make_train_step,
                                   train_state_from_model)
    from test_torch_train_archs import _batch, _jax_batch, _reference
    name = "granite-moe-3b-a800m"
    rcfg, npp = _reference(name)
    cfg = tget(name).reduced().replace(scan_layers=False)
    batch = _batch(cfg)
    got = {}
    for mb in (2, 1):
        state = train_state_from_model(
            cfg, params_from_numpy(cfg, npp, device="cpu"), TrainStepConfig())
        tperf.set_flags(microbatch=mb)
        _, m = make_train_step(cfg, "cpu")(
            state, {"tokens": torch.from_numpy(batch["tokens"])})
        got[mb] = {k: float(v) for k, v in m.items()}
    jts = JTS()
    jparams = jax.tree.map(jax.numpy.asarray, npp)
    jstate = {"params": jparams,
              "opt": jinit(jparams, _opt_cfg(rcfg, jts))._asdict(),
              "step": jax.numpy.zeros((), jax.numpy.int32)}
    with both_flags(microbatch=2), jax.disable_jit():
        jstep, _ = jmake(rcfg, make_host_mesh(1, 1), jts, donate=False)
        _, jm = jstep(jstate, _jax_batch(batch))
    for key in ("loss", "ce", "aux"):
        assert abs(got[2][key] - float(jm[key])) < 1e-3, key
    assert got[2]["ce"] == pytest.approx(got[1]["ce"], rel=2e-4)
    assert got[2]["aux"] != got[1]["aux"]


# ---------------------------------------------------------------------------
# The analytic engines, the simulator, obs
# ---------------------------------------------------------------------------


def _counters(sess) -> dict:
    return {k: v["value"] for k, v in sess.snapshot()["metrics"].items()
            if v["type"] == "counter"}


def _pn(q: int):
    from repro.core import pn_graph as ref_pn
    from repro_torch.convert import graph_from_arrays
    g = ref_pn(q)
    return g, graph_from_arrays(g.n, g.edges, g.meta, name=g.name)


def test_util_engine_is_the_default_of_engine_less_calls():
    """``util_engine=dense``: an engine-less ``utilization`` runs the
    dense engine (counted so under a session), with loads equal to
    ``engine="dense"`` bit for bit and within 1e-9 of the reference's
    engine-less call under ``util_engine=numpy``; a reference-only name
    raises with the argument's message."""
    from repro.core import utilization as ref_util
    from repro_torch.core import utilization
    g_ref, g = _pn(16)
    tperf.set_flags(util_engine="dense")
    with tobs.session("metrics") as s:
        rep = utilization(g, device="cpu")
    counts = _counters(s)
    assert counts.get("util.dispatch[dense]") == 1.0
    assert "util.engine[orbit]" not in counts
    want = utilization(g, engine="dense", device="cpu")
    np.testing.assert_array_equal(rep.loads, want.loads)
    _ref_perf().set_flags(util_engine="numpy")
    theirs = ref_util(g_ref)
    np.testing.assert_allclose(rep.loads, theirs.loads, rtol=1e-9)
    assert rep.kbar == pytest.approx(theirs.kbar, rel=1e-12)
    tperf.set_flags(util_engine="numpy")
    with pytest.raises(ValueError, match="numpy-only engines"):
        utilization(g, device="cpu")
    tperf.set_flags(util_engine="pallas")
    with pytest.raises(ValueError, match="names the reference's 'pallas'"):
        utilization(g, device="cpu")


def test_util_orbits_block_and_dense_max():
    """``util_orbits=0`` keeps ``auto`` off the orbit shortcut (the
    weighted path's uniform rerouting too) with the loads unchanged
    within 1e-9; ``util_block`` and ``util_dense_max`` change no load or
    distance."""
    from repro_torch.core import (arc_loads_weighted, bfs_distances_batched,
                                  utilization)
    _, g = _pn(8)
    auto = utilization(g, device="cpu")
    tperf.set_flags(util_orbits=False)
    with tobs.session("metrics") as s:
        exact = utilization(g, device="cpu")
        dem = np.ones((g.n, g.n)) - np.eye(g.n)
        weighted = arc_loads_weighted(g, dem, device="cpu")
    counts = _counters(s)
    assert "util.engine[orbit]" not in counts
    assert counts.get("util.engine[dense]") == 2.0
    np.testing.assert_allclose(exact.loads, auto.loads, rtol=1e-9)
    np.testing.assert_allclose(weighted[0], auto.loads, rtol=1e-9)
    tperf.set_flags(util_block=5)
    blocked = utilization(g, engine="dense", device="cpu")
    np.testing.assert_allclose(blocked.loads, auto.loads, rtol=1e-9)
    dense = bfs_distances_batched(g, np.arange(g.n), device="cpu")
    tperf.set_flags(util_dense_max=8)
    sparse = bfs_distances_batched(g, np.arange(g.n), device="cpu")
    assert torch.equal(dense, sparse)


def test_obs_flag_is_the_default_session_mode():
    """``obs`` resolves a session opened with no mode, in both
    packages."""
    from repro import obs as robs
    for mode in ("metrics", "trace"):
        with both_flags(obs=mode):
            with tobs.session() as s, robs.session() as rs:
                assert s.mode == rs.mode == mode
                assert tobs.current() is s
    with both_flags(obs="none"):
        with tobs.session() as s, robs.session() as rs:
            assert s is tobs.NULL_SESSION and rs is robs.NULL_SESSION
    assert tobs.current() is None


def test_sim_backend_is_the_default_of_auto():
    """``sim_backend`` is what ``auto`` defers to first in both packages;
    a fused run so picked equals an explicit one bit for bit; the
    reference's own names raise in the port with the argument's
    message."""
    from repro.core.traffic import make_pattern, normalize_demand
    from repro.sim.engine import pick_backend as ref_pick
    from repro_torch.sim import SimConfig, Simulator
    from repro_torch.sim.engine import pick_backend
    with both_flags(sim_backend="fused"):
        assert pick_backend("auto", 0) == "fused"
        assert pick_backend("dense", 0) == "dense"
    _ref_perf().set_flags(sim_backend="numpy")
    assert ref_pick("auto", 0) == "numpy"
    g_ref, g = _pn(7)
    dem = normalize_demand(make_pattern("uniform").demand(g_ref, None))
    runs = []
    for backend, flag in (("auto", "fused"), ("fused", "auto")):
        tperf.set_flags(sim_backend=flag)
        sim = Simulator(g, SimConfig(backend=backend, dtype="float64"),
                        demand=dem, device="cpu")
        assert sim.backend == "fused"
        runs.append(sim.run(dem, 0.5, 12))
    for key in runs[0].history:
        np.testing.assert_array_equal(runs[0].history[key],
                                      runs[1].history[key])
    tperf.set_flags(sim_backend="numpy")
    with pytest.raises(ValueError, match="unknown sim backend 'numpy'"):
        pick_backend("auto", 0)


# ---------------------------------------------------------------------------
# The mesh-only flags on one device
# ---------------------------------------------------------------------------


def _rep0(tree):
    """Layer 0 of a stacked body subtree."""
    if isinstance(tree, dict):
        return {k: _rep0(v) for k, v in tree.items()}
    return tree[0]


@pytest.mark.parametrize("flag", [{"bf16_experts": True},
                                  {"moe_3d": False},
                                  {"bf16_experts": True, "moe_3d": False}])
def test_mesh_only_flags_change_no_bit(flag):
    """``bf16_experts`` and ``moe_3d`` through the reference's
    ``apply_moe`` with no mesh and through the port's MoE block, at
    granite reduced in bf16: bit for bit with the flags as they were."""
    from repro.models.moe import apply_moe
    rcfg, npp = _arch_reference("granite-moe-3b-a800m")
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    p = _rep0(npp["body"]["pos0"]["mlp"])
    block = params_from_numpy(cfg, npp, device="cpu").blocks[
        cfg.moe.first_dense].mlp
    xj, xt = _x(cfg.d_model, 2, 13, seed=3)
    yj0, aj0 = apply_moe(rcfg, p, xj, mesh=None)
    with torch.no_grad():
        yt0, at0 = block(xt)
    with both_flags(**flag):
        yj1, aj1 = apply_moe(rcfg, p, xj, mesh=None)
        with torch.no_grad():
            yt1, at1 = block(xt)
    np.testing.assert_array_equal(_f32(yj0), _f32(yj1))
    assert float(aj0) == float(aj1)
    assert torch.equal(yt0, yt1) and torch.equal(at0, at1)


# ---------------------------------------------------------------------------
# The kernels' variants on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_prob_bf16_kernels_match_plain_versions():
    """On the card: #5 and #7's variants for the flag against their plain
    versions (o and dv within 2^-7 of the leaf's largest magnitude, lse
    within 1e-5 of the plain one's and at D = 64 of the default
    variant's, dk as the default variant's within its rule), bit for bit
    on a repeat; the launches per call as without the flag."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(8)
    for case in ATTN_CASES + [(1, 9, 3, 300, 300, 64, True, None)]:
        b, hq, hkv, sq, skv, d, causal, window = case
        if d not in FA.HEAD_DIMS:       # the dk/dv wrapper takes no pad
            continue
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).bfloat16().cuda() for shape in (
                (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
        do = torch.randn(q.shape, device="cuda").bfloat16()
        kw = dict(causal=causal, window=window)
        FA.reset_launches()
        o, lse = FA.flash_attention(q, k, v, prob_bf16=True, **kw)
        o2, _ = FA.flash_attention(q, k, v, prob_bf16=True, **kw)
        _, lse0 = FA.flash_attention(q, k, v, **kw)
        dsum = (do.float() * o.float()).sum(-1, keepdim=True)
        dk, dv = FA.flash_attention_dkv(q, k, v, do, lse, dsum,
                                        prob_bf16=True, **kw)
        dk0, _ = FA.flash_attention_dkv(q, k, v, do, lse, dsum, **kw)
        torch.cuda.synchronize()
        assert FA.LAUNCHES == {"flash_attention_fwd": 3,
                               "flash_attention_dq": 0,
                               "flash_attention_dkv": 2}
        assert torch.equal(o, o2)
        w_o, w_lse = ref.flash_attention_ref(q, k, v, prob_bf16=True, **kw)
        _, w_dv = ref.flash_attention_dkv_ref(q, k, v, do, lse, dsum,
                                              prob_bf16=True, **kw)
        _within(o.cpu(), w_o.cpu(), f"{case} o")
        _within(dv.cpu(), w_dv.cpu(), f"{case} dv")
        if d == 64:     # q scale exact in bf16: the cast leaves lse
            torch.testing.assert_close(lse, lse0, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, w_lse, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dk, dk0, atol=2e-4, rtol=2e-5)
