"""Heads of 256 (and 192, padded to 256 on the card) in repro_torch
against the reference, on the CPU.

The port's flash attention goes through ``FlashAttention`` (the plain
versions here; at D = 256 on the card the tensor-core kernels for bf16
operands, the CUDA-core ones for float32 operands) and is
held against the reference's Pallas kernels run through the interpreter,
forward (``_fwd``, o and the log-sum-exp) and backward (``jax.vjp`` of
``flash_attention``), on an MQA 4:1 case with a window shorter than S, a
causal case and a non-causal ragged one (Sq 48, Skv 80: no multiple of
the card's 64-row tiles).  Tolerances are ``test_torch_attention.py``'s
(o and lse at 3e-5 in float32) and ``test_torch_flash_bwd.py``'s
(gradients at 3e-3, the reference's own, and at 2e-5, since both sides
compute the same float32 sums in another order).

recurrentgemma-9b at ``reduced().replace(head_dim=256)`` (three layers,
the third local MQA attention with heads of 256) is held against the
reference model run op by op, as ``test_torch_models.py`` and
``test_torch_train_archs.py`` hold its reduced config: prefill and four
teacher-forced decode steps at 3e-2 on logits and cache, and loss,
gradients and one AdamW step under ``test_torch_train_archs.py``'s
rules.

The card's own D = 256 checks are the ``cuda``-marked tests of
``test_torch_attention.py`` and ``test_torch_flash_bwd.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.convert import (cache_to_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import build
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.train import (TrainStepConfig, make_train_step,
                               train_state_from_model)
from test_torch_models import _close, _close_tree
from test_torch_train import _leaves
from test_torch_train_archs import (LR, _batch, _grads, _hold_grads,
                                    _jax_batch)

CASES = [
    # (b, hq, hkv, sq, skv, causal, window, block): block is the Pallas
    # kernel's, which needs Sq and Skv to be multiples of it
    (1, 4, 1, 128, 128, True, 48, 64),        # MQA 4:1, window < S
    (1, 2, 2, 128, 128, True, None, 64),      # causal
    (1, 2, 2, 48, 80, False, None, 16),       # non-causal, ragged
]
HEADS = [256, 192]
TOL = 3e-5
PALLAS_TOL = 3e-3
TIGHT = 2e-5
RGEMMA = "recurrentgemma-9b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU products: torch's thread pool only adds latency here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(case, d, seed=0):
    b, hq, hkv, sq, skv = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                      (b, hq, sq, d))]


@functools.cache
def _pallas():
    """The reference's Pallas forward (``_fwd``: o and lse) and its
    ``jax.vjp`` (o, dq, dk, dv), interpreted and jitted."""
    import jax
    from repro.kernels.flash_attention import _fwd, flash_attention

    statics = ("causal", "window", "block")

    @functools.partial(jax.jit, static_argnames=statics)
    def fwd(q, k, v, causal, window, block):
        return _fwd(q, k, v, causal=causal, window=window, q_offset=0,
                    scale=q.shape[-1] ** -0.5, block_q=block,
                    block_k=block, interpret=True)

    @functools.partial(jax.jit, static_argnames=statics)
    def vjp(q, k, v, do, causal, window, block):
        o, back = jax.vjp(lambda q, k, v: flash_attention(
            q, k, v, causal=causal, window=window, block_q=block,
            block_k=block, interpret=True), q, k, v)
        return (o,) + back(do)

    return fwd, vjp


@pytest.mark.parametrize("d", HEADS)
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_pallas_interpret(case, d):
    import jax.numpy as jnp
    b, hq, hkv, sq, skv, causal, window, block = case
    arrs = _arrays(case, d)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    o, lse = FA.flash_attention(q, k, v, causal=causal, window=window)
    want_o, want_lse = _pallas()[0](*map(jnp.asarray, arrs[:3]),
                                    causal=causal, window=window,
                                    block=block)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=TOL,
                               rtol=TOL)
    assert FA.LAUNCHES["flash_attention_fwd"] == 0       # CPU: no kernel


@pytest.mark.parametrize("d", HEADS)
@pytest.mark.parametrize("case", CASES)
def test_function_grads_match_pallas_backward_interpret(case, d):
    """``FlashAttention`` (the plain dq and dk/dv versions on the CPU)
    against ``jax.vjp`` of the reference's Pallas kernels."""
    import jax.numpy as jnp
    b, hq, hkv, sq, skv, causal, window, block = case
    arrs = _arrays(case, d, seed=1)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    o = FA.FlashAttention.apply(q, k, v, causal, window, 0, None)
    got = (o,) + torch.autograd.grad(o, (q, k, v),
                                     torch.from_numpy(arrs[3]))
    want = _pallas()[1](*map(jnp.asarray, arrs), causal=causal,
                        window=window, block=block)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=PALLAS_TOL, rtol=PALLAS_TOL,
                                   err_msg=f"{name} {case} D={d}")
        np.testing.assert_allclose(g, w, atol=TIGHT, rtol=TIGHT,
                                   err_msg=f"{name} {case} D={d} (tight)")
    assert all(n == 0 for n in FA.LAUNCHES.values())


@pytest.mark.parametrize("d,padded", [(16, 32), (120, 128), (129, 256),
                                      (192, 256), (256, 256)])
def test_pad_head(d, padded):
    """The head size the card's kernels run a head of ``d`` at: the next
    of HEAD_DIMS; 192 (deepseek-v3's MLA q/k head) runs at 256, with
    float32 operands (the CUDA-core kernels) as with bf16 ones."""
    assert FA._pad_head(d) == padded
    assert FA.HEAD_DIMS == (32, 64, 128, 256)
    assert FA.FMA_HEAD_MAX == 256


# ---------------------------------------------------------------------------
# recurrentgemma with heads of 256
# ---------------------------------------------------------------------------


def _cfg(mod):
    return mod.get_arch(RGEMMA).reduced().replace(head_dim=256,
                                                  scan_layers=False)


@functools.cache
def _reference():
    """(reference cfg, bundle, params, numpy params), run op by op."""
    import jax
    from repro import configs as rcfgs
    from repro.models import build as jbuild
    from repro.models import unbox
    cfg = _cfg(rcfgs)
    bundle = jbuild(cfg)
    params = unbox(bundle.init(jax.random.key(0)))
    return cfg, bundle, params, jax.tree.map(np.asarray, params)


def test_config_reaches_the_head_256_kernels():
    cfg = _cfg(tcfg)
    assert cfg.resolved_head_dim == 256 and cfg.n_kv_heads == 1
    mixer = build(cfg).init(0, device="cpu").blocks[2].mixer
    assert tuple(mixer.wq.shape) == (cfg.d_model, cfg.n_heads, 256)
    assert tuple(mixer.wk.shape) == (cfg.d_model, 1, 256)


def test_prefill_and_decode_match_reference():
    """Prefill of 12 tokens and four teacher-forced decode steps against
    the reference's, logits and caches at 3e-2."""
    import jax.numpy as jnp
    _, bundle, params, npp = _reference()
    cfg = _cfg(tcfg)
    model = params_from_numpy(cfg, npp, device="cpu")
    tb = build(cfg)
    s, n_dec, slots = 12, 4, 16
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab, (1, s + n_dec)).astype(np.int32)
    lj, cj = bundle.prefill(params, jnp.asarray(tokens[:, :s]), impl="auto",
                            cache_slots=slots)
    lt, ct = tb.prefill(model, torch.from_numpy(tokens[:, :s]).long(),
                        cache_slots=slots)
    _close(lt, lj, "prefill logits")
    _close_tree(cache_to_numpy(cfg, ct), cj, "prefill cache")
    for i in range(n_dec):
        tok = tokens[:, s + i:s + i + 1]
        pos = np.full((1, 1), s + i, np.int32)
        lj, cj = bundle.decode_step(params, cj, jnp.asarray(tok),
                                    jnp.asarray(pos))
        lt, ct = tb.decode_step(model, ct, torch.from_numpy(tok).long(),
                                torch.from_numpy(pos))
        _close(lt, lj, f"decode step {i} logits")
    _close_tree(cache_to_numpy(cfg, ct), cj, "decode cache")


def test_loss_and_grads_match_reference():
    """``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
    reference's: the loss within 1e-3, every leaf by ``_close_grads``."""
    import jax
    from repro.models.model import loss_fn as jloss
    rcfg, _, _, npp = _reference()
    cfg = _cfg(tcfg)
    batch = _batch(cfg)
    params = jax.tree.map(jax.numpy.asarray, npp)
    (jl, _), jg = jax.value_and_grad(
        lambda p, b: jloss(rcfg, p, b), has_aux=True)(params,
                                                      _jax_batch(batch))
    model = params_from_numpy(cfg, npp, device="cpu")
    loss, _, grads = _grads(cfg, model, batch)
    assert abs(float(loss) - float(jl)) < 1e-3
    got = _leaves(params_to_numpy(cfg, grads))
    want = _leaves(jax.tree.map(np.asarray, jg))
    assert _hold_grads(got, want, _leaves(npp), RGEMMA) == ([], [])
    assert np.any(want["/prefix/2/mixer/wq"])      # attention takes part


def test_train_step_matches_reference_step():
    """One full step (loss, gradients, clipping, AdamW with the cosine
    schedule) against the reference's ``make_train_step`` on a (1, 1)
    host mesh, run op by op: the loss within 1e-3, the gradient norm at
    3e-2, weights whose gradient is clear of the bf16 noise (|g| > 0.1
    of the leaf's largest) within 1e-6, the others within 2 lr."""
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import make_host_mesh
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import adamw_init as jinit
    from repro.optim import cosine_schedule as jcos
    from repro.train import TrainStepConfig as JTS
    from repro.train import make_train_step as jmake
    from repro.train.train_step import _opt_cfg
    rcfg, _, _, npp = _reference()
    cfg = _cfg(tcfg)
    batch = _batch(cfg)
    jts = JTS(optimizer=JAdamW(lr=jcos(LR, warmup=2, total=10)))
    jparams = jax.tree.map(jnp.asarray, npp)
    jstate = {"params": jparams,
              "opt": jinit(jparams, _opt_cfg(rcfg, jts))._asdict(),
              "step": jnp.zeros((), jnp.int32)}
    jstep, _ = jmake(rcfg, make_host_mesh(1, 1), jts, donate=False)
    with jax.disable_jit():
        jnew, jm = jstep(jstate, _jax_batch(batch))
    want = _leaves(jax.tree.map(np.asarray, jnew["params"]))

    ts = TrainStepConfig(optimizer=AdamWConfig(lr=cosine_schedule(
        LR, warmup=2, total=10)))
    state = train_state_from_model(
        cfg, params_from_numpy(cfg, npp, device="cpu"), ts)
    new, m = make_train_step(cfg, "cpu", ts)(state, batch)
    assert int(new["step"]) == int(jnew["step"]) == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-3
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=3e-2)
    _, _, grads = _grads(cfg, params_from_numpy(cfg, npp, device="cpu"),
                         batch)
    gmag = _leaves(params_to_numpy(cfg, grads))
    got = _leaves(params_to_numpy(cfg, new["params"]))
    p0 = _leaves(npp)
    for key in want:
        clear = np.abs(gmag[key]) > 0.1 * np.abs(gmag[key]).max()
        assert clear.any(), key
        np.testing.assert_allclose(got[key][clear], want[key][clear],
                                   atol=1e-6, rtol=0, err_msg=key)
        assert np.abs(got[key] - want[key]).max() <= 2 * LR + 1e-6, key
        assert np.any(got[key] != p0[key]), key


def test_train_launcher_cuts_the_depth(tmp_path):
    """``--n-layers`` keeps the config's width and cuts its depth (the
    card's recurrentgemma-9b train cell runs its published width at 3 of
    38 layers): the reduced config at 2 layers (two RG-LRU blocks) and at
    its whole 3 trains a step through the launcher."""
    from repro_torch.launch.train import main
    for n in (2, 3):
        trainer, state = main(["--arch", RGEMMA, "--reduced", "--n-layers",
                               str(n), "--device", "cpu", "--steps", "1",
                               "--seq", "16", "--batch", "1", "--ckpt-dir",
                               str(tmp_path / str(n))])
        assert trainer.cfg.n_layers == n
        assert trainer.cfg.d_model == tcfg.get_arch(RGEMMA).reduced().d_model
        assert int(state["step"]) == 1
        assert np.isfinite(trainer.history[0].loss)
