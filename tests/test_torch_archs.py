"""The MoE, MLA and RG-LRU families of repro_torch against the reference,
module by module, at the ``reduced()`` sizes on the CPU.

The reference's weights go into the port through
``convert.params_from_numpy``; inputs are drawn from numpy seeds.  The
whole-model prefill + decode runs of these archs are in
``test_torch_models.py`` (``_prefill_and_decode``), the engine in
``test_torch_serve.py``.

Tolerances: float32 paths 1e-5 (the RG-LRU scan: a doubling scan against
``jax.lax.associative_scan``, the same products in another order; the MoE
block in float32), 1e-6 for the router's weights and the aux loss on
identical float32 logits, indices exact; bfloat16 activations and caches
3e-2, as ``test_torch_models.py`` (both sides compute in bf16 with float32
accumulation but round at different places; the reference's dense MoE
path sums the experts in bf16, the port its k picks in float32).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.ref import moe_dense_ref
from repro_torch.models import moe as tmoe

TOL = 3e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU products: torch's thread pool only adds latency here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _reference(name: str, seed: int = 0):
    """(reference cfg, numpy params) of the reduced arch."""
    import jax
    from repro.configs import get_arch
    from repro.models import build as jbuild
    from repro.models import unbox
    cfg = get_arch(name).reduced()
    params = unbox(jbuild(cfg).init(jax.random.key(seed)))
    return cfg, jax.tree.map(np.asarray, params)


@functools.cache
def _port(name: str, seed: int = 0):
    cfg = tcfg.get_arch(name).reduced()
    return cfg, params_from_numpy(cfg, _reference(name, seed)[1],
                                  device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol,
                               err_msg=what)


def _rep0(tree):
    """Layer 0 of a stacked body subtree."""
    if isinstance(tree, dict):
        return {k: _rep0(v) for k, v in tree.items()}
    return tree[0]


def _x(d, b, s, dtype, seed=0):
    """The same normal (B, S, d) input for both sides in ``dtype``."""
    import jax.numpy as jnp
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), t.to(torch.bfloat16)
    return jnp.asarray(x), t


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _tied_logits(t, e, seed):
    """Float32 router logits with exact ties planted at the top-k edge and
    across whole rows."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(t, e)).astype(np.float32)
    order = np.argsort(-logits, axis=1, kind="stable")
    for row in range(0, t, 3):               # tie the k-th and (k+1)-th
        k = 1 + row % (e - 1)
        logits[row, order[row, k]] = logits[row, order[row, k - 1]]
    logits[1] = 0.5                           # a row of equal logits
    logits[4, ::2] = logits[4, 0]             # every other expert tied
    return logits


@pytest.mark.parametrize("name,full", [("granite-moe-3b-a800m", False),
                                       ("granite-moe-3b-a800m", True),
                                       ("deepseek-v3-671b", False)])
def test_router_topk_is_exact_on_ties(name, full):
    """Indices equal the reference's ``jax.lax.top_k`` picks (lower index
    first on a tie) on identical float32 logits; weights and probabilities
    at 1e-6."""
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.models.moe import router_topk
    rcfg = get_arch(name) if full else get_arch(name).reduced()
    cfg = tcfg.get_arch(name) if full else tcfg.get_arch(name).reduced()
    logits = _tied_logits(37, cfg.moe.n_experts, seed=5)
    pj, wj, ij = router_topk(rcfg, jnp.asarray(logits))
    pt, wt, it = tmoe.router_topk(cfg, torch.from_numpy(logits))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert it.shape == (37, cfg.moe.top_k)
    assert it[1].tolist() == list(range(cfg.moe.top_k))   # the equal row
    _close(wt, wj, "top_w", tol=1e-6)
    _close(pt, pj, "probs", tol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_aux_loss_matches_reference(seed):
    import jax.numpy as jnp
    from repro.models.moe import moe_aux_loss
    rng = np.random.default_rng(seed)
    e, k = 8, 2
    logits = rng.normal(size=(50, e)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=1, kind="stable")[:, :k]
    want = moe_aux_loss(jnp.asarray(probs), jnp.asarray(idx), e)
    got = tmoe.moe_aux_loss(torch.from_numpy(probs), torch.from_numpy(idx),
                            e)
    _close(got, want, "aux", tol=1e-6)


def _moe_layer(name):
    """(reference cfg, reference MoE params, port cfg, port MoE module)
    of the first MoE layer."""
    rcfg, np_params = _reference(name)
    cfg, model = _port(name)
    first = cfg.moe.first_dense
    p = _rep0(np_params["body"]["pos0"]["mlp"])
    assert not first or "router" not in np_params["prefix"][0]["mlp"]
    return rcfg, p, cfg, model.blocks[first].mlp


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "deepseek-v3-671b"])
def test_moe_block_matches_reference_dense_path(name, dtype):
    """The block (router, scatter into bins of T rows, batched experts,
    weighted gather, shared expert) against ``apply_moe(mesh=None,
    impl="dense")``: 3e-2 in bf16, 1e-5 in float32, the aux loss too.
    The reference runs eagerly, op by op as the port: under ``jax.jit``
    XLA fuses the norm into the router's product and rounds the bf16
    logits otherwise, which flips deepseek's token (0, 5) here on a tie
    (the port and the eager reference give the same bf16 logits, bit for
    bit)."""
    from repro.models.moe import apply_moe
    rcfg, p, cfg, block = _moe_layer(name)
    assert (block.shared is not None) == (cfg.moe.n_shared > 0)
    xj, xt = _x(cfg.d_model, 2, 13, dtype, seed=3)
    yj, aj = apply_moe(rcfg, p, xj, mesh=None, impl="dense")
    with torch.no_grad():
        yt, at = block(xt)
    tol = TOL if dtype == "bfloat16" else 1e-5
    assert yt.dtype == xt.dtype
    _close(yt, yj, f"{name} moe y", tol=tol)
    _close(at, aj, f"{name} moe aux", tol=tol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_route_against_its_oracle(dtype):
    """The route alone against ``moe_dense_ref`` (the reference's dense
    path in plain torch) on the same routing: in float32 at 1e-5; in bf16
    at 3e-2 against the oracle rounding as the reference does, and within
    one bf16 rounding (1e-4 + 2^-7 |y|) against the oracle weighting and
    summing in float32, as the route does.  A repeated call is equal."""
    cfg, model = _port("granite-moe-3b-a800m")
    block = model.blocks[0].mlp
    _, x = _x(cfg.d_model, 1, 40, dtype, seed=4)
    x2d = x[0]
    with torch.no_grad():
        logits = x2d @ block.router.to(x2d.dtype)
        _, top_w, top_idx = tmoe.router_topk(cfg, logits)
        got = block.route(x2d, top_w, top_idx)
        want = moe_dense_ref(x2d, block.w_gate, block.w_up, block.w_down,
                             top_w, top_idx)
        want32 = moe_dense_ref(x2d, block.w_gate, block.w_up, block.w_down,
                               top_w, top_idx, acc_dtype=torch.float32)
        assert torch.equal(got, block.route(x2d, top_w, top_idx))
    if dtype == "float32":
        _close(got, want, "route vs dense oracle", tol=1e-5)
        _close(got, want32, "route vs dense oracle", tol=1e-5)
        return
    _close(got, want, "route vs dense oracle in bf16")
    np.testing.assert_allclose(_f32(got), _f32(want32), atol=1e-4,
                               rtol=2 ** -7, err_msg="route vs float32 sum")


def test_moe_route_against_reference_dense_path_on_its_routing():
    """``moe_dense_ref`` is the reference's ``_dense_path``: same routing,
    same weights, float32, 1e-5."""
    import jax.numpy as jnp
    from repro.models.moe import _dense_path
    rcfg, p, cfg, block = _moe_layer("granite-moe-3b-a800m")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(21, cfg.d_model)).astype(np.float32)
    idx = np.stack([rng.permutation(cfg.moe.n_experts)[:cfg.moe.top_k]
                    for _ in range(21)])
    w = rng.uniform(size=idx.shape).astype(np.float32)
    want = _dense_path(rcfg, p, jnp.asarray(x), jnp.asarray(w),
                       jnp.asarray(idx))
    t = torch.from_numpy
    got = moe_dense_ref(t(x), block.w_gate.detach(), block.w_up.detach(),
                        block.w_down.detach(), t(w), t(idx))
    _close(got, want, "moe_dense_ref vs _dense_path", tol=1e-5)


@pytest.mark.cuda
def test_cuda_moe_route_matches_dense_oracle():
    """On the card: the route against ``moe_dense_ref`` weighting and
    summing in float32 at a full-width granite-moe layer's shapes (40
    experts top-8, d_model 1536, width 512) in bf16, within one bf16
    rounding (1e-4 + 2^-7 |y|), and a repeated call bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = tcfg.get_arch("granite-moe-3b-a800m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    block = tmoe.MoE(cfg, device="cuda", generator=gen)
    x2d = torch.randn((257, cfg.d_model), device="cuda",
                      generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        _, top_w, top_idx = tmoe.router_topk(
            cfg, x2d @ block.router.to(torch.bfloat16))
        got = block.route(x2d, top_w, top_idx)
        want = moe_dense_ref(x2d, block.w_gate, block.w_up, block.w_down,
                             top_w, top_idx, acc_dtype=torch.float32)
        again = block.route(x2d, top_w, top_idx)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               atol=1e-4, rtol=2 ** -7, err_msg="cuda route")
    assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# Attention with a value head narrower than q / k (MLA)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,skv", [(True, None, 19),
                                               (False, None, 23),
                                               (True, 6, 19)])
def test_attention_with_a_narrow_value_head(dtype, causal, window, skv):
    """q, k at 32, v at 16 (deepseek reduced's MLA) against the reference's
    ``ops.attention(impl="jnp")``: float32 1e-5, bf16 3e-2."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rng = np.random.default_rng(8)
    q, k = (rng.normal(size=(2, 4, n, 32)).astype(np.float32)
            for n in (19, skv))
    v = rng.normal(size=(2, 4, skv, 16)).astype(np.float32)
    scale = 32 ** -0.5 * 1.3
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jops.attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                          causal=causal, window=window, scale=scale,
                          q_offset=skv - 19, impl="jnp")
    tdt = getattr(torch, dtype)
    got = ops.attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                        causal=causal, window=window, scale=scale,
                        q_offset=skv - 19)
    assert got.shape == (2, 4, 19, 16) and got.dtype == tdt
    _close(got, want, "narrow v", tol=TOL if dtype == "bfloat16" else 1e-5)


def test_attention_refuses_a_wider_value_head():
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="value head 32"):
        ops.attention(q, q, torch.zeros((1, 2, 4, 32)))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _lru_inputs(b, s, d, seed):
    rng = np.random.default_rng(seed)
    x, ag, ig = (rng.normal(size=(b, s, d)).astype(np.float32)
                 for _ in range(3))
    a_param = rng.normal(size=d).astype(np.float32)
    state = rng.normal(size=(b, d)).astype(np.float32)
    return x, ag, ig, a_param, state


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 37, 64])
def test_rglru_scan_matches_reference(s, with_state):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    x, ag, ig, a_param, state = _lru_inputs(2, s, 24, seed=s)
    st = state if with_state else None
    yj, fj = jops.rglru(*(jnp.asarray(a) for a in (x, ag, ig, a_param)),
                        state=None if st is None else jnp.asarray(st),
                        c=8.0)
    t = torch.from_numpy
    yt, ft = ops.rglru(t(x), t(ag), t(ig), t(a_param),
                       state=None if st is None else t(st), c=8.0)
    assert yt.shape == (2, s, 24) and ft.dtype == torch.float32
    _close(yt, yj, "rglru y", tol=1e-5)
    _close(ft, fj, "rglru final state", tol=1e-5)


def test_rglru_decode_step_matches_reference():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    x, ag, ig, a_param, state = _lru_inputs(3, 1, 24, seed=9)
    args = (state, x[:, 0], ag[:, 0], ig[:, 0], a_param)
    yj, sj = jops.rglru_decode_step(*(jnp.asarray(a) for a in args), c=8.0)
    yt, s_t = ops.rglru_decode_step(*(torch.from_numpy(a) for a in args),
                                    c=8.0)
    _close(yt, yj, "rglru step y", tol=1e-5)
    _close(s_t, sj, "rglru step state", tol=1e-5)
    # the step continues the scan: scan(S + 1) == scan(S), then one step
    t = torch.from_numpy
    _, last = ops.rglru(t(x), t(ag), t(ig), t(a_param), state=t(state))
    x2, ag2, ig2, _, _ = _lru_inputs(3, 1, 24, seed=10)
    y_step, _ = ops.rglru_decode_step(last, t(x2[:, 0]), t(ag2[:, 0]),
                                      t(ig2[:, 0]), t(a_param))
    cat = lambda a, b2: t(np.concatenate([a, b2], axis=1))  # noqa: E731
    y_all, _ = ops.rglru(cat(x, x2), cat(ag, ag2), cat(ig, ig2),
                         t(a_param), state=t(state))
    _close(y_step, y_all[:, -1], "step after scan", tol=1e-5)


def test_rglru_block_prefill_and_decode():
    """recurrentgemma's recurrent block: prefill (a ragged 2-token prompt,
    shorter than the conv tail, and 19 tokens) and 3 decode steps; y, the
    conv tail and the state at 3e-2."""
    from repro.models.rglru import apply_rglru_block
    rcfg, np_params = _reference("recurrentgemma-9b")
    cfg, model = _port("recurrentgemma-9b")
    blk = model.blocks[0].mixer
    p = _rep0(np_params["body"]["pos0"]["mixer"])
    for s in (2, 19):
        xj, xt = _x(cfg.d_model, 2, s, "bfloat16", seed=s)
        yj, cj = apply_rglru_block(rcfg, p, xj, mode="prefill")
        with torch.no_grad():
            yt, ct = blk(xt, mode="prefill")
        _close(yt, yj, f"prefill y S={s}")
        for key in ("conv", "state"):
            assert ct[key].shape == tuple(cj[key].shape)
            _close(ct[key], cj[key], f"prefill {key} S={s}")
        assert ct["state"].dtype == torch.float32
    for step in range(3):
        xj1, xt1 = _x(cfg.d_model, 2, 1, "bfloat16", seed=20 + step)
        yj, cj = apply_rglru_block(rcfg, p, xj1, mode="decode", cache=cj)
        with torch.no_grad():
            yt, ct = blk(xt1, mode="decode", cache=ct)
        _close(yt, yj, f"decode y {step}")
        for key in ("conv", "state"):
            _close(ct[key], cj[key], f"decode {key} {step}")


def test_rglru_block_prefill_from_a_cached_state():
    from repro.models.rglru import apply_rglru_block
    rcfg, np_params = _reference("recurrentgemma-9b")
    cfg, model = _port("recurrentgemma-9b")
    blk = model.blocks[1].mixer
    p = _rep0(np_params["body"]["pos1"]["mixer"])
    xj, xt = _x(cfg.d_model, 1, 11, "bfloat16", seed=2)
    _, cj = apply_rglru_block(rcfg, p, xj, mode="prefill")
    xj2, xt2 = _x(cfg.d_model, 1, 7, "bfloat16", seed=3)
    yj, cj2 = apply_rglru_block(rcfg, p, xj2, mode="prefill", cache=cj)
    with torch.no_grad():
        _, ct = blk(xt, mode="prefill")
        yt, ct2 = blk(xt2, mode="prefill", cache=ct)
    _close(yt, yj, "prefill y from a state")
    _close(ct2["state"], cj2["state"], "final state from a state")


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots", [None, 20])
def test_mla_block_prefill_and_decode(slots):
    """deepseek reduced's MLA: prefill through the kernel's plain version
    (v of 16 padded to 32) with the cache padded to ``slots``, then two
    rows at different positions decode against the compressed cache; y
    and the cache at 3e-2."""
    import jax.numpy as jnp
    from repro.models.layers import apply_mla
    rcfg, np_params = _reference("deepseek-v3-671b")
    cfg, model = _port("deepseek-v3-671b")
    mla = model.blocks[0].mixer
    p = np_params["prefix"][0]["mixer"]
    s = 12
    xj, xt = _x(cfg.d_model, 2, s, "bfloat16")
    yj, cj = apply_mla(rcfg, p, xj, positions=jnp.arange(s), mode="prefill",
                       cache_slots=slots, impl="jnp")
    with torch.no_grad():
        yt, ct = mla(xt, positions=torch.arange(s), mode="prefill",
                     cache_slots=slots)
    _close(yt, yj, "prefill y")
    for key in ("ckv", "krope"):
        assert ct[key].shape == tuple(cj[key].shape)
        _close(ct[key], cj[key], f"prefill {key}")
    if slots is None:
        return
    pos = np.array([[s], [s + 3]], np.int32)
    for step in range(2):
        xj1, xt1 = _x(cfg.d_model, 2, 1, "bfloat16", seed=1 + step)
        yj, cj = apply_mla(rcfg, p, xj1, positions=jnp.asarray(pos + step),
                           mode="decode", cache=cj)
        with torch.no_grad():
            yt, ct = mla(xt1, positions=torch.from_numpy(pos + step),
                         mode="decode", cache=ct)
        _close(yt, yj, f"decode y {step}")
        for key in ("ckv", "krope"):
            _close(ct[key], cj[key], f"decode {key} {step}")


# ---------------------------------------------------------------------------
# Weights, the loss
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "deepseek-v3-671b",
                                  "recurrentgemma-9b"])
def test_params_round_trip_every_weight(name):
    """Every reference weight (the MoE with its shared expert, the MLA
    mixer, the RG-LRU mixer, deepseek's dense prefix and its MTP head)
    loads strictly and comes back equal."""
    _, np_params = _reference(name)
    cfg, model = _port(name)
    back = params_to_numpy(cfg, model)
    want = dict(_leaves(np_params))
    got = dict(_leaves(back))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(arr, np.float32),
                                      err_msg=key)
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(a).size for a in want.values())
    assert (model.mtp is not None) == cfg.mtp


def test_loss_adds_the_aux_loss():
    """granite reduced trains: ce and the aux loss against the reference's
    ``loss_fn`` at 3e-2; an MTP config adds its ``mtp`` term (held
    against the reference in ``test_torch_train_archs.py``)."""
    import jax.numpy as jnp
    from repro.models.model import loss_fn as jloss
    from repro_torch.models import build, loss_fn
    rcfg, np_params = _reference("granite-moe-3b-a800m")
    cfg, model = _port("granite-moe-3b-a800m")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16))
    lj, mj = jloss(rcfg, np_params, {"tokens": jnp.asarray(tokens)})
    lt, mt = loss_fn(cfg, model, {"tokens": torch.from_numpy(tokens)})
    _close(mt["ce"], mj["ce"], "ce")
    _close(mt["aux"], mj["aux"], "aux")
    _close(lt, lj, "loss")
    assert float(mt["aux"].detach()) > 0
    dcfg, dmodel = _port("deepseek-v3-671b")
    ld, md = build(dcfg).loss(dmodel, {"tokens": torch.from_numpy(tokens)})
    assert set(md) == {"ce", "aux", "mtp"}
    assert float(ld.detach()) == pytest.approx(
        float(md["ce"].detach() + md["aux"].detach()
              + 0.3 * md["mtp"].detach()), rel=1e-6)
