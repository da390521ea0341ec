"""The memory-input families of repro_torch against the reference:
seamless-m4t-large-v2 (the encoder over stub frame embeddings, decoder
layers with self- and cross-attention) and llama-3.2-vision-90b (gated
cross-attention layers to image embeddings).

Both sides run the same weights (the reference's, through
``convert.params_from_numpy``) on the same tokens and the same memory,
drawn from a seed with numpy.  Every cross layer's ``gate`` is set to 1.0
on both sides first (in the reference's numpy tree, before loading):
the reference initialises it to zero, and tanh(0) = 0 would leave the
cross-attention out of every comparison.  ``test_memory_matters`` shows
that with the gates at 1.0 the memory moves the logits well beyond the
tolerance.

The vision config is held at ``reduced().replace(n_layers=10)``:
``reduced()`` keeps 4 layers, and the pattern's ``xattn`` sits at index
4, so it would have no cross layer.  Ten layers give two periods, with
``xattn`` at layers 4 and 9.  It is held against the reference run op by
op (``scan_layers=False``, decode not jitted): the reference's scanned
forward differs from its own unrolled one by 0.047 in these logits (XLA
rounds the compiled bf16 steps otherwise), beyond 3e-2, while the port
lies within 3e-2 of the unrolled one.  seamless is unrolled already.

Tolerances: 3e-2 absolute and relative on bf16 activations, caches and
float32 logits, as in ``test_torch_models.py`` (the reference's own
tolerance between its prefill, decode and full forward); ``kpos`` is
held exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.models import build, loss_fn

TOL = 3e-2
GAP = 0.05
SEAMLESS = "seamless-m4t-large-v2"
VISION = "llama-3.2-vision-90b"
NAMES = [SEAMLESS, VISION]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU products: torch's thread pool only adds latency here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, name):
    """The reduced config of ``name`` from the configs module ``mod``
    (the reference's or the port's): vision at ten layers, unrolled."""
    cfg = mod.get_arch(name).reduced()
    if name == VISION:
        cfg = cfg.replace(n_layers=10, scan_layers=False)
    return cfg


def _gates_at_one(tree):
    if isinstance(tree, dict):
        return {k: (np.ones_like(v) if k == "gate" else _gates_at_one(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_gates_at_one(v) for v in tree]
    return tree


@functools.cache
def _reference(name: str):
    """(reference cfg, bundle, params with every gate at 1.0, numpy copy
    of them)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as rcfgs
    from repro.models import build as jbuild
    from repro.models import unbox
    cfg = _cfg(rcfgs, name)
    bundle = jbuild(cfg)
    params = unbox(bundle.init(jax.random.key(0)))
    np_params = _gates_at_one(jax.tree.map(np.asarray, params))
    return cfg, bundle, jax.tree.map(jnp.asarray, np_params), np_params


def _port(name: str):
    cfg = _cfg(tcfg, name)
    return cfg, params_from_numpy(cfg, _reference(name)[3], device="cpu")


def _memory(cfg, t, seed=3, b=1):
    """(B, T, M) float32 embeddings, uniform in [-1, 1) as the data
    pipeline's stub memory."""
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (b, t, cfg.d_model)).astype(np.float32)


def _frames(cfg, s):
    """The memory length that the reference's ``input_specs`` gives an S
    prompt: S // frame_ratio frames, or the image tokens."""
    if cfg.encoder is not None:
        return max(1, s // cfg.encoder.frame_ratio)
    return cfg.vision.n_image_tokens


def _tokens(cfg, s, seed=7, b=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol,
                               err_msg=what)


def _close_tree(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for key in want:
            _close_tree(got[key], want[key], f"{what}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, f"{what}[{i}]")
    elif what.endswith("kpos"):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)
    else:
        _close(got, want, what)


def _bf16(x):
    import jax.numpy as jnp
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


# ---------------------------------------------------------------------------
# The cross-attention layer and the encoder
# ---------------------------------------------------------------------------


def _cross_layer(name):
    """(reference cfg, the first cross layer's numpy weights, the port's
    layer): seamless's ``cross`` of layer 0, vision's ``xattn`` mixer of
    layer 4."""
    rcfg, _, _, np_params = _reference(name)
    _, model = _port(name)
    if name == SEAMLESS:
        return rcfg, np_params["prefix"][0]["cross"], model.blocks[0].cross
    return rcfg, np_params["prefix"][4]["mixer"], model.blocks[4].mixer


@pytest.mark.parametrize("name", NAMES)
def test_cross_attention_layer_prefill_and_decode(name):
    """GQA (4 q / 2 kv heads) against a memory of odd length 7: prefill
    (K, V from the memory, cached at its length), decode from that cache,
    and decode with no cache (K, V projected again)."""
    import jax.numpy as jnp
    from repro.models.layers import apply_attention
    rcfg, p, att = _cross_layer(name)
    p = {k: jnp.asarray(v) for k, v in p.items()}
    assert att.wk.shape[1] == 2 and att.wq.shape[1] == 4
    b, s = 2, 9
    rng = np.random.default_rng(0)
    xj, xt = _bf16(rng.normal(size=(b, s, rcfg.d_model)).astype(np.float32))
    mj, mt = _bf16(_memory(rcfg, 7, b=b))
    yj, cj = apply_attention(rcfg, p, xj, positions=jnp.arange(s),
                             mode="prefill", memory=mj, impl="jnp")
    with torch.no_grad():
        yt, ct = att(xt, positions=torch.arange(s), mode="prefill",
                     memory=mt)
    _close(yt, yj, "prefill y")
    _close_tree(ct, cj, "prefill cache")
    assert ct["k"].shape == (b, 2, 7, rcfg.resolved_head_dim)
    pos = np.array([[s], [s + 3]], np.int32)
    xj1, xt1 = _bf16(rng.normal(size=(b, 1, rcfg.d_model))
                     .astype(np.float32))
    for cache_j, cache_t, what in ((cj, ct, "cached"), (None, None, "none")):
        yj, cj2 = apply_attention(rcfg, p, xj1, positions=jnp.asarray(pos),
                                  mode="decode", cache=cache_j, memory=mj)
        with torch.no_grad():
            yt, ct2 = att(xt1, positions=torch.from_numpy(pos),
                          mode="decode", cache=cache_t, memory=mt)
        _close(yt, yj, f"decode y ({what})")
        _close_tree(ct2, cj2, f"decode cache ({what})")
    assert ct2["k"] is not ct["k"]


def test_encoder_matches_reference():
    """The encoder (adapter, two bidirectional layers, final norm) on 9
    frames against the reference's ``_run_encoder``."""
    import jax.numpy as jnp
    from repro.models.transformer import _run_encoder
    rcfg, _, params, _ = _reference(SEAMLESS)
    _, model = _port(SEAMLESS)
    fj, ft = _bf16(_memory(rcfg, 9, b=2))
    want = _run_encoder(rcfg, params["encoder"], fj, None, "jnp")
    with torch.no_grad():
        got = model.encoder(ft)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, rcfg.d_model)
    _close(got, want, "encoder output")
    assert float(jnp.abs(want).max()) > 0.5


# ---------------------------------------------------------------------------
# The slice as a whole: prefill, then teacher-forced decode
# ---------------------------------------------------------------------------


def _prefill_and_decode(name, impl="auto", n_dec=4, s=12, slots=16,
                        memory=True):
    import jax.numpy as jnp
    rcfg, bundle, params, _ = _reference(name)
    cfg, model = _port(name)
    tb = build(cfg)
    tokens = _tokens(cfg, s + n_dec)
    mem = _memory(cfg, _frames(cfg, s)) if memory else None
    lj, cj = bundle.prefill(params, jnp.asarray(tokens[:, :s]),
                            memory=None if mem is None else jnp.asarray(mem),
                            impl=impl, cache_slots=slots)
    lt, ct = tb.prefill(model, torch.from_numpy(tokens[:, :s]).long(),
                        memory=None if mem is None else torch.from_numpy(mem),
                        cache_slots=slots)
    _close(lt, lj, f"{name} prefill logits")
    _close_tree(cache_to_numpy(cfg, ct), cj, f"{name} prefill cache")
    for i in range(n_dec):
        tok = tokens[:, s + i:s + i + 1]
        pos = np.full((1, 1), s + i, np.int32)
        lj, cj = bundle.decode_step(params, cj, jnp.asarray(tok),
                                    jnp.asarray(pos))
        lt, ct = tb.decode_step(model, ct, torch.from_numpy(tok).long(),
                                torch.from_numpy(pos))
        _close(lt, lj, f"{name} decode step {i} logits")
    _close_tree(cache_to_numpy(cfg, ct), cj, f"{name} decode cache")
    return ct


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_reference(name):
    ct = _prefill_and_decode(name)
    assert set(ct) == {"layers", "enc_memory"}
    assert ct["enc_memory"].dtype == torch.bfloat16


def test_prefill_matches_reference_pallas_kernels():
    """The reference's side through its Pallas kernels (interpreter): the
    encoder's non-causal self-attention (Sq = Skv = 3 frames), the
    decoder's causal self-attention and the cross-attention (Sq = 12,
    Skv = 3)."""
    _prefill_and_decode(SEAMLESS, "pallas_interpret", n_dec=1)


def test_vision_without_memory_matches_reference():
    """With no image embeddings the reference runs each ``xattn`` layer
    as causal self-attention (rope, no gate, no window, a cache of the
    prompt's length, which decode then overwrites as a ring); the
    port does the same.  No ``enc_memory`` enters the cache."""
    ct = _prefill_and_decode(VISION, memory=False)
    assert isinstance(ct, list) and ct[4]["mixer"]["k"].shape[2] == 12


def test_loss_with_memory_matches_reference():
    """``loss_fn`` passes ``batch["memory"]`` through: ce against the
    reference's ``loss_fn`` at 3e-2 (seamless under remat: the encoder's
    layers checkpointed too), and the encoder's weights get a finite,
    nonzero gradient."""
    import jax.numpy as jnp
    from repro.models.model import loss_fn as jloss
    rcfg, _, params, _ = _reference(SEAMLESS)
    cfg, model = _port(SEAMLESS)
    assert cfg.remat
    tokens = _tokens(cfg, 16, seed=2, b=2)
    mem = _memory(cfg, 4, b=2)
    lj, mj = jloss(rcfg, params, {"tokens": jnp.asarray(tokens),
                                  "memory": jnp.asarray(mem)})
    lt, mt = loss_fn(cfg, model, {"tokens": torch.from_numpy(tokens),
                                  "memory": torch.from_numpy(mem)})
    _close(mt["ce"], mj["ce"], "ce")
    _close(lt, lj, "loss")
    lt.backward()
    grad = model.encoder.adapter.grad
    assert grad is not None and bool(torch.isfinite(grad).all())
    assert float(grad.abs().max()) > 0
    model.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# Gates, memory, weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_gates_start_at_zero(name):
    """The port's init, like the reference's, gives every cross layer a
    zero gate, so a fresh model's logits do not depend on the memory."""
    cfg = _cfg(tcfg, name)
    tb = build(cfg)
    model = tb.init(0, device="cpu")
    gates = [p.detach() for n, p in model.named_parameters()
             if n.endswith(".gate")]
    assert len(gates) == (cfg.n_layers if name == SEAMLESS else 2)
    assert all(g.dim() == 0 and float(g) == 0.0 for g in gates)
    tokens = torch.from_numpy(_tokens(cfg, 8)).long()
    t = _frames(cfg, 8)
    la, _ = tb.prefill(model, tokens, memory=torch.from_numpy(
        _memory(cfg, t, seed=1)))
    lb, _ = tb.prefill(model, tokens, memory=torch.from_numpy(
        _memory(cfg, t, seed=2)))
    assert torch.equal(la, lb)


@pytest.mark.parametrize("name", NAMES)
def test_memory_matters(name):
    """With the gates at 1.0 a second memory draw moves the prefill
    logits by more than the parity tolerance."""
    cfg, model = _port(name)
    tb = build(cfg)
    tokens = torch.from_numpy(_tokens(cfg, 12)).long()
    t = _frames(cfg, 12)
    la, _ = tb.prefill(model, tokens, memory=torch.from_numpy(
        _memory(cfg, t, seed=3)))
    lb, _ = tb.prefill(model, tokens, memory=torch.from_numpy(
        _memory(cfg, t, seed=4)))
    assert float((la - lb).abs().max()) > TOL


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", NAMES)
def test_params_round_trip_with_encoder_and_gates(name):
    """Every reference weight (the encoder's stacked layers, adapter and
    final norm; each cross layer with its gate) loads strictly and comes
    back equal."""
    np_params = _reference(name)[3]
    cfg, model = _port(name)
    back = params_to_numpy(cfg, model)
    want = dict(_leaves(np_params))
    got = dict(_leaves(back))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(arr, np.float32),
                                      err_msg=key)
    assert (model.encoder is not None) == (name == SEAMLESS)
    assert any(key.endswith(".gate") for key in want)


def test_cache_round_trip_and_concat_with_memory():
    """Caches with cross entries and ``enc_memory`` merge along axis 0
    and survive a trip through numpy."""
    cfg, model = _port(SEAMLESS)
    tb = build(cfg)
    mem = torch.from_numpy(_memory(cfg, 3))
    caches = [tb.prefill(model, torch.from_numpy(_tokens(cfg, n, seed=n))
                         .long(), memory=mem, cache_slots=16)[1]
              for n in (5, 9)]
    merged = tb.concat_caches(caches)
    assert merged["enc_memory"].shape == (2, 3, cfg.d_model)
    assert merged["layers"][1]["cross"]["k"].shape[0] == 2
    back = cache_from_numpy(cfg, cache_to_numpy(cfg, merged), device="cpu")
    assert torch.equal(back["enc_memory"], merged["enc_memory"])
    for a, b in zip(back["layers"], merged["layers"]):
        for part in ("mixer", "cross"):
            for key, t in b[part].items():
                assert torch.equal(a[part][key], t)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _solo_port(bundle, model, prompt, toks, max_len, memory):
    logits, cache = bundle.prefill(model, torch.from_numpy(prompt[None])
                                   .long(), memory=torch.from_numpy(memory),
                                   cache_slots=max_len)
    rows = [logits[0, -1]]
    for i, t in enumerate(toks[:-1]):
        pos = torch.full((1, 1), len(prompt) + i)
        logits, cache = bundle.decode_step(model, cache,
                                           torch.tensor([[t]]), pos)
        rows.append(logits[0, 0])
    return torch.stack(rows).numpy()


def _solo_reference(bundle, params, prompt, toks, max_len, memory):
    import jax.numpy as jnp
    logits, cache = bundle.prefill(params, jnp.asarray(prompt[None]),
                                   memory=jnp.asarray(memory),
                                   cache_slots=max_len)
    rows = [np.asarray(logits[0, -1], np.float32)]
    for i, t in enumerate(toks[:-1]):
        pos = jnp.full((1, 1), len(prompt) + i, jnp.int32)
        logits, cache = bundle.decode_step(params, cache,
                                           jnp.asarray([[t]], jnp.int32),
                                           pos)
        rows.append(np.asarray(logits[0, 0], np.float32))
    return np.stack(rows)


def _near_argmax(toks, solo, what):
    for i, t in enumerate(toks):
        gap = solo[i].max() - solo[i][t]
        assert gap <= GAP, f"{what} step {i}: token {t} gap {gap:.4f}"


@pytest.mark.parametrize("name", NAMES)
def test_engine_with_memory_matches_reference_engine(name):
    """Both engines serve five prompts (lengths 3 to 9, batches of 2) with
    one batch-1 memory that every prefill takes; every token the port's
    engine emits lies within 0.05 of the max logit of a solo teacher-
    forced run of the port and of the reference (the reference's own
    rule, ``tests/test_system.py``)."""
    from repro.serve.engine import Engine as JEngine
    from repro.serve.engine import ServeConfig as JServeConfig
    from repro_torch.serve import Engine, ServeConfig
    rcfg, jbundle, params, _ = _reference(name)
    cfg, model = _port(name)
    max_len, max_new = 32, 5
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(3, 10)))
               .astype(np.int32) for _ in range(5)]
    mem = _memory(cfg, _frames(cfg, 8), seed=5)
    eng = Engine(cfg, model, ServeConfig(max_batch=2, max_len=max_len),
                 device="cpu")
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    mine = eng.run(memory=mem)
    jeng = JEngine(rcfg, params, JServeConfig(max_batch=2, max_len=max_len))
    for p in prompts:
        jeng.submit(p, max_new=max_new)
    theirs = jeng.run(memory=mem)
    assert sorted(mine) == rids and len(theirs) == 5 and not eng.queue
    bundle = build(cfg)
    for rid, prompt in zip(rids, prompts):
        toks = mine[rid]
        assert len(toks) == max_new
        _near_argmax(toks, _solo_port(bundle, model, prompt, toks, max_len,
                                      mem), f"{name} req {rid} vs port solo")
        _near_argmax(toks, _solo_reference(jbundle, params, prompt, toks,
                                           max_len, mem),
                     f"{name} req {rid} vs reference solo")


def test_serve_launcher_refuses_an_encoder_arch(capsys):
    """The launcher makes no frame embeddings: an encoder arch raises
    ValueError (the reference's launcher fails on ``None.astype``); a
    vision arch is served with none, as the reference serves it."""
    from repro_torch.launch.serve import main, serve
    with pytest.raises(ValueError, match=r"Engine\.run\(memory="):
        serve(SEAMLESS, device="cpu")
    main(["--arch", VISION, "--device", "cpu", "--requests", "2",
          "--max-new", "2", "--max-batch", "2"])
    assert "served 2 requests / 4 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_flash_attention_at_the_memory_shapes():
    """On the card: kernel #5 in bf16 at the memory families' regimes,
    non-causal throughout: the encoder's Sq = Skv (ragged, 97), a cross
    prefill with Sq != Skv (130 q rows against 97 keys), a cross decode
    step (Sq = 1, one live row of a 64-row q tile), and a head of 128
    with 8 / 1 GQA.  o within one bf16 rounding (1e-4 + 2^-7 |o|) of the
    plain version, the log-sum-exp at 3e-5, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(24)
    cases = [  # (b, hq, hkv, sq, skv, d)
        (1, 4, 4, 97, 97, 64), (1, 4, 2, 130, 97, 64),
        (3, 4, 2, 1, 97, 64), (2, 8, 1, 1, 200, 128),
        (1, 8, 1, 70, 200, 128)]
    before = FA.LAUNCHES["flash_attention_fwd"]
    for b, hq, hkv, sq, skv, d in cases:
        q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda")
                   .bfloat16() for h, n in ((hq, sq), (hkv, skv),
                                            (hkv, skv)))
        o, lse = FA.flash_attention(q, k, v, causal=False)
        w_o, w_lse = flash_attention_ref(q, k, v, causal=False)
        what = f"b={b} hq={hq} hkv={hkv} sq={sq} skv={skv} d={d}"
        torch.testing.assert_close(o.float(), w_o.float(), atol=1e-4,
                                   rtol=2.0 ** -7, msg=what)
        torch.testing.assert_close(lse, w_lse, atol=3e-5, rtol=3e-5,
                                   msg=what)
    assert FA.LAUNCHES["flash_attention_fwd"] == before + len(cases)
