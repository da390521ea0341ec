"""The model substrate of repro_torch against the reference: configs,
blocks, and a whole prefill + teacher-forced decode per family.

The reference's weights (``unbox(bundle.init(key))`` as numpy arrays)
go into the port through ``convert.params_from_numpy``, so both sides
run the same model on the same tokens; the port runs on the CPU, where
its kernels' plain versions stand in for the CUDA kernels.

Tolerances: 3e-2 absolute and relative on bfloat16 activations, cache
entries and float32 logits.  Both sides compute in bfloat16 with float32
accumulation but round at different places; 3e-2 is what the reference
uses to hold its own prefill and decode against its full forward
(``tests/test_archs.py``).  ``kpos`` and the SSD conv tail are copies of
positions and projections, held exactly.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,
                                 params_from_numpy)
from repro_torch.models import build

TOL = 3e-2

# archs held against the reference run op by op: its unrolled layers
# (``scan_layers=False``, the same weights and function) and its decode
# step not jitted.  recurrentgemma's scanned forward differs from its own
# unrolled forward by 0.0586 in the reduced prefill logits (seed 0, tokens
# of seed 7), and its jitted decode step from the eager one by up to 0.038,
# beyond 3e-2: XLA compiles those and rounds their bf16 steps otherwise
# than op-by-op dispatch.  The port's prefill equals the unrolled forward
# bit for bit there.
UNROLLED = {"recurrentgemma-9b"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU products: torch's thread pool only adds latency here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _reference(name: str, seed: int = 0, window=None):
    """(reference cfg, bundle, params, decode_step (jitted unless the arch
    is in UNROLLED), numpy params)."""
    import jax
    from repro.configs import get_arch
    from repro.models import build as jbuild
    from repro.models import unbox
    cfg = get_arch(name).reduced()
    if window is not None:
        cfg = cfg.replace(window=window)
    if name in UNROLLED:
        cfg = cfg.replace(scan_layers=False)
    bundle = jbuild(cfg)
    params = unbox(bundle.init(jax.random.key(seed)))
    decode = (bundle.decode_step if name in UNROLLED
              else jax.jit(bundle.decode_step))
    return cfg, bundle, params, decode, jax.tree.map(np.asarray, params)


def _port(name: str, seed: int = 0, window=None):
    cfg = tcfg.get_arch(name).reduced()
    if window is not None:
        cfg = cfg.replace(window=window)
    if name in UNROLLED:
        cfg = cfg.replace(scan_layers=False)
    return cfg, params_from_numpy(cfg, _reference(name, seed, window)[4],
                                  device="cpu")


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


def _tokens(cfg, s, seed=0, b=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def test_configs_are_the_references():
    from repro.configs import ARCHS
    assert sorted(tcfg.ARCHS) == sorted(ARCHS)
    for name, ref_cfg in ARCHS.items():
        for full in (True, False):
            mine = tcfg.get_arch(name)
            want = ref_cfg
            if not full:
                mine, want = mine.reduced(), want.reduced()
            assert dataclasses.asdict(mine) == dataclasses.asdict(want), name
    assert tcfg.get_arch("smollm-135m").param_dtype is torch.float32


def test_build_refuses_what_is_not_ported():
    """Every config of the reference builds, the memory-input families
    (seamless's encoder, llama-3.2-vision's cross layers) included; an
    SSD layer without its SSMConfig is refused."""
    assert len(tcfg.ARCHS) == 10
    for name in tcfg.ARCHS:
        for cfg in (tcfg.get_arch(name), tcfg.get_arch(name).reduced()):
            assert build(cfg).cfg is cfg
    with pytest.raises(ValueError, match="SSMConfig"):
        build(tcfg.get_arch("mamba2-130m").replace(ssm=None))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activation_rounds_as_the_reference(act):
    """The MLP's SiLU and GELU equal ``jax.nn.silu`` / ``jax.nn.gelu`` bit
    for bit on every bf16 input whose steps stay clear of the subnormals
    (XLA flushes those to zero, torch keeps them), and SiLU's gradient is
    ``F.silu``'s."""
    import jax
    import jax.numpy as jnp
    from repro_torch.models import layers
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    x = x[(x.float().abs() > 1e-30) & (x.float().abs() < 80)]
    mine = getattr(layers, act)(x).float().numpy()
    want = getattr(jax.nn, act)(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(mine, np.asarray(want, np.float32))
    if act == "silu":
        xg = x[:4096].clone().requires_grad_(True)
        g = torch.randn(xg.shape, generator=torch.Generator().manual_seed(0)
                        ).bfloat16()
        (got,) = torch.autograd.grad(layers.silu(xg), xg, g)
        (ref,) = torch.autograd.grad(torch.nn.functional.silu(xg), xg, g)
        assert torch.equal(got, ref)


def test_params_from_numpy_keeps_every_weight():
    from repro.models import count_params
    cfg, model = _port("smollm-135m")
    ref_cfg = _reference("smollm-135m")[0]
    assert sum(p.numel() for p in model.parameters()) == count_params(
        ref_cfg) + cfg.d_model * (1 + 2 * cfg.n_layers)  # + the norms
    np_params = _reference("smollm-135m")[4]
    np.testing.assert_array_equal(
        model.blocks[1].mixer.wq.detach().numpy(),
        np_params["body"]["pos0"]["mixer"]["wq"][1])
    assert model.lm_head is None                 # tied embeddings


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _x(cfg, b, s, seed=0):
    import jax.numpy as jnp
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)) \
        .astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


def _layer0(np_params):
    return {k: v[0] for k, v in np_params["body"]["pos0"]["mixer"].items()}


@pytest.mark.parametrize("name,window,slots", [
    ("smollm-135m", None, 16),                   # linear cache, padded
    ("h2o-danube-3-4b", 8, None)])               # sliding-window ring
def test_attention_block_prefill_and_decode(name, window, slots):
    import jax.numpy as jnp
    from repro.models.layers import apply_attention
    rcfg, _, _, _, np_params = _reference(name, 0, window)
    cfg, model = _port(name, 0, window)
    att = model.blocks[0].mixer
    p = _layer0(np_params)
    s = 12
    xj, xt = _x(cfg, 2, s)
    yj, cj = apply_attention(rcfg, p, xj, positions=jnp.arange(s),
                             mode="prefill", window=rcfg.window,
                             cache_slots=slots, impl="jnp")
    yt, ct = att(xt, positions=torch.arange(s), mode="prefill",
                 window=cfg.window, cache_slots=slots)
    _close(yt, yj, "prefill y")
    _close_tree(ct, cj, "prefill cache")
    # two rows at different positions decode against the cache
    pos = np.array([[s], [s + 3]], np.int32)
    xj1, xt1 = _x(cfg, 2, 1, seed=1)
    yj, cj = apply_attention(rcfg, p, xj1, positions=jnp.asarray(pos),
                             mode="decode", cache=cj, window=rcfg.window)
    yt, ct = att(xt1, positions=torch.from_numpy(pos), mode="decode",
                 cache=ct, window=cfg.window)
    _close(yt, yj, "decode y")
    _close_tree(ct, cj, "decode cache")


def test_ssd_block_prefill_and_decode():
    from repro.models.ssm import apply_ssd_block
    rcfg, _, _, _, np_params = _reference("mamba2-130m")
    cfg, model = _port("mamba2-130m")
    blk = model.blocks[0].mixer
    p = _layer0(np_params)
    xj, xt = _x(cfg, 1, 45)                      # ragged: 45 = 32 + 13
    yj, cj = apply_ssd_block(rcfg, p, xj, mode="prefill", impl="jnp")
    yt, ct = blk(xt, mode="prefill")
    _close(yt, yj, "prefill y")
    np.testing.assert_array_equal(_f32(ct["conv"]), _f32(cj["conv"]))
    _close(ct["state"], cj["state"], "prefill state")
    for step in range(3):
        xj1, xt1 = _x(cfg, 1, 1, seed=2 + step)
        yj, cj = apply_ssd_block(rcfg, p, xj1, mode="decode", cache=cj)
        yt, ct = blk(xt1, mode="decode", cache=ct)
        _close(yt, yj, f"decode y {step}")
        _close(ct["state"], cj["state"], f"decode state {step}")
    # the conv tail is the last d_conv - 1 projected inputs
    assert ct["conv"].shape == (1, cfg.ssm.d_conv - 1, cj["conv"].shape[-1])


def test_ssd_block_prefill_from_a_cached_state():
    """A cache given at prefill seeds the scan with its state, as the
    reference's ``apply_ssd_block`` does (3e-2 on bf16 y, the state)."""
    from repro.models.ssm import apply_ssd_block
    rcfg, _, _, _, np_params = _reference("mamba2-130m")
    cfg, model = _port("mamba2-130m")
    blk = model.blocks[0].mixer
    p = _layer0(np_params)
    xj, xt = _x(cfg, 1, 30)
    _, cj = apply_ssd_block(rcfg, p, xj, mode="prefill", impl="jnp")
    _, ct = blk(xt, mode="prefill")
    xj2, xt2 = _x(cfg, 1, 15, seed=7)
    yj, cj2 = apply_ssd_block(rcfg, p, xj2, mode="prefill", cache=cj,
                              impl="jnp")
    yt, ct2 = blk(xt2, mode="prefill", cache=ct)
    _close(yt, yj, "prefill y from a state")
    _close(ct2["state"], cj2["state"], "final state from a state")
    _, fresh = blk(xt2, mode="prefill")
    assert not torch.allclose(fresh["state"], ct2["state"])


def test_causal_conv_matches_reference():
    """The K shifted multiply-adds against XLA's grouped convolution."""
    import jax.numpy as jnp
    from repro.models.ssm import _causal_conv as jconv
    from repro_torch.models.ssm import _causal_conv
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    got = _causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    want = jconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(got, want, "conv", tol=1e-5)


# ---------------------------------------------------------------------------
# The slice as a whole: prefill, then teacher-forced decode
# ---------------------------------------------------------------------------


def _prefill_and_decode(name, impl, n_dec=4, window=None, slots=16, s=12):
    import jax.numpy as jnp
    rcfg, bundle, params, jdecode, _ = _reference(name, 0, window)
    cfg, model = _port(name, 0, window)
    tb = build(cfg)
    tokens = _tokens(cfg, s + n_dec, seed=7)
    lj, cj = bundle.prefill(params, jnp.asarray(tokens[:, :s]), impl=impl,
                            cache_slots=slots)
    lt, ct = tb.prefill(model, torch.from_numpy(tokens[:, :s]).long(),
                        cache_slots=slots)
    _close(lt, lj, f"{name} prefill logits")
    _close_tree(cache_to_numpy(cfg, ct), cj, f"{name} prefill cache")
    for i in range(n_dec):
        tok = tokens[:, s + i:s + i + 1]
        pos = np.full((1, 1), s + i, np.int32)
        lj, cj = jdecode(params, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = tb.decode_step(model, ct, torch.from_numpy(tok).long(),
                                torch.from_numpy(pos))
        _close(lt, lj, f"{name} decode step {i} logits")
    _close_tree(cache_to_numpy(cfg, ct), cj, f"{name} decode cache")
    return ct


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-130m",
                                  "granite-moe-3b-a800m", "deepseek-v3-671b",
                                  "recurrentgemma-9b"])
def test_prefill_and_decode_match_reference(name):
    _prefill_and_decode(name, "auto")


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-130m",
                                  "granite-moe-3b-a800m"])
def test_prefill_matches_reference_pallas_kernels(name):
    """The reference's side through its Pallas kernels (interpreter)."""
    _prefill_and_decode(name, "pallas_interpret", n_dec=1)


def test_sliding_window_ring_decodes_past_the_window():
    """Danube-style SWA with window 8: a ring cache of 8 slots, decoded
    12 steps past the prompt."""
    ct = _prefill_and_decode("h2o-danube-3-4b", "auto", n_dec=12,
                             window=8, slots=None)
    assert ct[0]["mixer"]["k"].shape[2] == 8


def test_cache_round_trip_and_concat():
    cfg, model = _port("mamba2-130m")
    tb = build(cfg)
    _, c1 = tb.prefill(model, torch.from_numpy(_tokens(cfg, 5)).long())
    _, c2 = tb.prefill(model, torch.from_numpy(_tokens(cfg, 9, 1)).long())
    merged = tb.concat_caches([c1, c2])
    assert merged[1]["mixer"]["state"].shape[0] == 2
    back = cache_from_numpy(cfg, cache_to_numpy(cfg, merged), device="cpu")
    for a, b in zip(back, merged):
        for key in ("conv", "state"):
            assert torch.equal(a["mixer"][key], b["mixer"][key])
