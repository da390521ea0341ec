"""The optimizers of repro_torch against the reference's.

The same parameters and gradients (numpy, from a seed) go through the
reference's ``repro.optim`` and the port's ``repro_torch.optim``.
Tolerances: AdamW parameters within 1e-6 over 5 steps (both sides do
the same float32 operations in the same order; XLA and torch may round
the global norm's sums differently by an ulp, which moves the clip
scale), float32 moments within 1e-6 of the leaf's largest moment, bf16
moments within one bf16 rounding (2^-8 relative) of it; the schedule
within 3e-7 relative (the two libraries' float32 cos differ by an ulp);
int8 codes, scales and the error-feedback round trip exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import optim as topt

SHAPES = {"w": (24, 16), "b": (16,), "emb": (40, 8), "gain": (8,)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(tree, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_reference_over_five_steps(state_dtype, schedule):
    import jax.numpy as jnp
    from repro import optim as jopt
    lr_j = jopt.cosine_schedule(1e-2, warmup=2, total=5) if schedule \
        else 1e-2
    lr_t = topt.cosine_schedule(1e-2, warmup=2, total=5) if schedule \
        else 1e-2
    jcfg = jopt.AdamWConfig(lr=lr_j, grad_clip=0.5,
                            state_dtype=getattr(jnp, state_dtype))
    tcfg = topt.AdamWConfig(lr=lr_t, grad_clip=0.5,
                            state_dtype=getattr(torch, state_dtype))
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = _torch(p0)
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    for step in range(5):
        g = _tree(10 + step, scale=0.3)
        jp, js, jm = jopt.adamw_update({k: jnp.asarray(v)
                                        for k, v in g.items()}, js, jp, jcfg)
        tp, ts, tm = topt.adamw_update(_torch(g), ts, tp, tcfg)
        assert int(ts.count) == int(js.count) == step + 1
        np.testing.assert_allclose(_np(tm["grad_norm"]), _np(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(_np(tm["lr"]), _np(jm["lr"]), rtol=1e-7)
        for k in SHAPES:
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), atol=1e-6,
                                       rtol=0, err_msg=f"{k} step {step}")
            assert ts.m[k].dtype == getattr(torch, state_dtype)
            rtol = 1e-6 if state_dtype == "float32" else 2.0 ** -8
            for got, want in ((ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
                want = _np(want)
                np.testing.assert_allclose(_np(got), want, rtol=rtol,
                                           atol=rtol * np.abs(want).max())


def test_adamw_leaves_its_inputs_and_keeps_dtypes():
    p = _torch(_tree(1))
    p["gain"] = p["gain"].to(torch.bfloat16)
    keep = {k: v.clone() for k, v in p.items()}
    state = topt.adamw_init(p)
    new_p, new_state, _ = topt.adamw_update(_torch(_tree(2)), state, p)
    for k in p:
        assert torch.equal(p[k], keep[k])
        assert new_p[k].dtype == p[k].dtype
    assert int(state.count) == 0 and int(new_state.count) == 1


def test_adamw_decreases_quadratic():
    w = {"w": torch.tensor([3.0, -2.0, 5.0])}
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0)
    state = topt.adamw_init(w, cfg)
    for _ in range(200):
        w, state, _ = topt.adamw_update({"w": 2 * w["w"]}, state, w, cfg)
    assert float(w["w"].abs().max()) < 0.05


def test_cosine_schedule_matches_reference():
    import jax.numpy as jnp
    from repro import optim as jopt
    for peak, warm, total in ((1e-3, 20, 200), (3e-4, 1, 10), (1.0, 0, 5)):
        j = jopt.cosine_schedule(peak, warm, total)
        t = topt.cosine_schedule(peak, warm, total)
        steps = np.arange(0, total + 6)
        got = t(torch.from_numpy(steps).to(torch.int32))
        want = np.asarray(j(jnp.asarray(steps, jnp.int32)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-7, atol=1e-9)


def test_global_norm_matches_reference():
    import jax.numpy as jnp
    from repro import optim as jopt
    g = _tree(3)
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    assert float(topt.global_norm(_torch(g))) == pytest.approx(want,
                                                               rel=1e-6)


def test_global_norm_does_not_depend_on_the_leaf_order():
    """The leaves' sums of squares add in the order of their sorted names,
    as ``jax.tree.leaves`` orders a dict: a state restored from a
    checkpoint (its dicts sorted) steps as the state in memory (the
    model's order) did, bit for bit, also where the norm clips."""
    rng = np.random.default_rng(7)
    g = {f"blocks.{i}.w{j}": torch.from_numpy(
        (rng.normal(size=(rng.integers(1, 40), 7))
         * 10.0 ** rng.integers(-3, 3)).astype(np.float32))
        for i in range(12) for j in range(3)}
    want = topt.global_norm(dict(sorted(g.items())))
    for order in (list(g), list(reversed(g)),
                  [k for k in rng.permutation(list(g))]):
        assert torch.equal(topt.global_norm({k: g[k] for k in order}), want)


@pytest.mark.parametrize("shape,scale", [((37, 13), 1e-3), ((256,), 10.0),
                                         ((5, 300), 1.0), ((4, 4), 0.0)])
def test_compress_codes_identical_to_reference(shape, scale):
    import jax.numpy as jnp
    from repro import optim as jopt
    rng = np.random.default_rng(int(scale * 1000) + shape[0])
    g = (rng.normal(size=shape) * scale).astype(np.float32)
    j_codes, j_scale, j_pad = jopt.compress(jnp.asarray(g))
    t_codes, t_scale, t_pad = topt.compress(torch.from_numpy(g))
    assert t_codes.dtype == torch.int8 and t_pad == j_pad
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(t_scale.numpy(), np.asarray(j_scale))
    np.testing.assert_array_equal(
        topt.decompress(t_codes, t_scale, t_pad, shape).numpy(),
        np.asarray(jopt.decompress(j_codes, j_scale, j_pad, shape)))


def test_error_feedback_matches_reference_over_steps():
    import jax.numpy as jnp
    from repro import optim as jopt
    g0 = _tree(4, scale=0.01)
    je = jopt.ef_init({k: jnp.asarray(v) for k, v in g0.items()})
    te = topt.ef_init(_torch(g0))
    for step in range(4):
        g = _tree(20 + step, scale=0.01)
        jg, je = jopt.ef_compress_grads({k: jnp.asarray(v)
                                         for k, v in g.items()}, je)
        tg, te = topt.ef_compress_grads(_torch(g), te)
        for k in SHAPES:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))


def test_error_feedback_accumulates_residual():
    g = {"w": torch.full((8,), 0.001)}
    e = topt.ef_init(g)
    total = torch.zeros(8)
    for _ in range(50):
        approx, e = topt.ef_compress_grads(g, e)
        total += approx["w"]
    np.testing.assert_allclose((total / 50).numpy(), 0.001, rtol=0.05)
