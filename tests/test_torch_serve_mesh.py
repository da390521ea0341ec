"""Serving on a mesh: the prefill and decode of the dense GQA, SSD and
RG-LRU families under a ``DeviceMesh``, ``Engine(mesh=)``, and the
caches' specs against the reference's.

Reduced smollm-135m, h2o-danube-3-4b (a sliding window of 64: a ring
cache), mamba2-130m and recurrentgemma-9b (its local attention's window
of 64 too) serve over 4 gloo processes on a (2, 2) ("data", "model")
mesh, the weights placed by their specs (``place_params``): a prefill of
4 rows of 62 tokens, then three teacher-forced decode steps (the third
writes slot 64 mod 64 = 0 of the windowed archs' rings), and an engine
serving five prompts in batches of 4 and 1.  Each is held against the
same run in one process; the one process against the reference's
``prefill`` and ``decode_step`` on the same weights (its initial ones,
key 0, unrolled: ``scan_layers=False``, through
``convert.params_from_numpy``)."""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.convert import cache_to_numpy, params_from_numpy

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("smollm-135m", "h2o-danube-3-4b", "mamba2-130m",
         "recurrentgemma-9b")
# the prefill's rows and tokens, the decode steps after it
ROWS, SEQ, STEPS = 4, 62, 3
# the engine's queue: five prompts of 3 to 9 tokens, 6 new tokens each
PROMPTS, MAX_NEW, MAX_LEN, MAX_BATCH = 5, 6, 64, 4
GAP = 0.05


def _cfg(mod, arch):
    """The reduced config of ``arch`` from the configs module ``mod``
    (the reference's or the port's), unrolled."""
    return mod.get_arch(arch).reduced().replace(scan_layers=False)


def _slots(cfg) -> int:
    """The prefill's cache slots: a windowed arch's window (its ring
    wraps at the third decode step), else room for every step."""
    return cfg.window or SEQ + STEPS + 1


def _ref_tree(arch) -> dict:
    import jax
    from repro import configs as rcfgs
    from repro.models import build as jbuild
    from repro.models import unbox
    return jax.tree.map(np.asarray, unbox(
        jbuild(_cfg(rcfgs, arch)).init(jax.random.key(0))))


def _tokens(cfg, seed: int = 3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (ROWS, SEQ + STEPS)).astype(np.int32)


def _prompts(cfg, seed: int = 4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, int(rng.integers(3, 10)))
            .astype(np.int32) for _ in range(PROMPTS)]


@pytest.fixture(autouse=True)
def _one_thread_no_group():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    assert not dist.is_initialized()
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", **kw)
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_PERF", None)
    return env


SERVE_RUN = textwrap.dedent("""
    def serve(cfg, model, tokens, slots, steps, mesh):
        # a prefill of tokens[:, :-steps], then one teacher-forced decode
        # step per remaining token: each step's logits and whole cache
        import numpy as np
        import torch
        from repro_torch.models import build
        bundle = build(cfg)
        whole = (lambda t: t.full_tensor()) if mesh is not None else \\
            (lambda t: t)

        def host(tree):
            if isinstance(tree, dict):
                return {k: host(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [host(v) for v in tree]
            t = whole(tree)
            return np.array((t.float() if t.is_floating_point() else t)
                            .numpy())

        s = tokens.shape[1] - steps
        tok = torch.from_numpy(tokens).long()
        kw = {} if mesh is None else {"mesh": mesh}
        logits, cache = bundle.prefill(model, tok[:, :s], cache_slots=slots,
                                       **kw)
        out = {"logits": [host(logits)], "cache": [host(cache)]}
        for i in range(steps):
            pos = torch.full((tok.shape[0], 1), s + i)
            logits, cache = bundle.decode_step(
                model, cache, tok[:, s + i:s + i + 1], pos, **kw)
            out["logits"].append(host(logits))
            out["cache"].append(host(cache))
        return out
""")

GLOO = SERVE_RUN + textwrap.dedent("""
    import pickle, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import place_params
    from repro_torch.serve import Engine, ServeConfig

    with open(f"{tmp}/job.pkl", "rb") as f:
        job = pickle.load(f)
    out = {}
    for arch, (cfg, tree, tokens, slots, steps, prompts, scfg) in \\
            job.items():
        model = place_params(params_from_numpy(cfg, tree, device="cpu"),
                             mesh)
        out[arch] = serve(cfg, model, tokens, slots, steps, mesh)
        eng = Engine(cfg, model, ServeConfig(**scfg), device="cpu",
                     mesh=mesh)
        rids = [eng.submit(p, max_new=max_new) for p, max_new in prompts]
        res = eng.run()
        out[arch]["engine"] = [res[r] for r in rids]
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's report of :data:`GLOO`, and each arch's (cfg,
    weights, tokens, slots, steps, prompts, serve config)."""
    from repro_torch import configs as tcfgs
    tmp = tmp_path_factory.mktemp("serve_mesh")
    job = {}
    for arch in ARCHS:
        cfg = _cfg(tcfgs, arch)
        job[arch] = (cfg, _ref_tree(arch), _tokens(cfg), _slots(cfg), STEPS,
                     [(p, MAX_NEW) for p in _prompts(cfg)],
                     dict(max_batch=MAX_BATCH, max_len=MAX_LEN))
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO, str(r), port, str(tmp)],
        env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    reps = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            reps.append(pickle.load(f))
    return {"reps": reps, "job": job}


@pytest.fixture(scope="module")
def one_process(runs):
    """The same prefill and decode steps of each arch in one process."""
    ns: dict = {}
    exec(SERVE_RUN, ns)
    out = {}
    for arch, (cfg, tree, tokens, slots, steps, _, _) in \
            runs["job"].items():
        model = params_from_numpy(cfg, tree, device="cpu")
        out[arch] = ns["serve"](cfg, model, tokens, slots, steps, None)
    return out


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# the limits against the one-process run, of each array's largest
# magnitude: the logits and the bf16 leaves one bf16 rounding, the
# float32 recurrent states 1e-4 (kpos exact); recurrentgemma's logits
# two roundings and its RG-LRU states 1e-3 (see the test's docstring)
LIMITS = {"logits": 2.0 ** -7, "k": 2.0 ** -7, "v": 2.0 ** -7,
          "conv": 2.0 ** -7, "state": 1e-4}
ARCH_LIMITS = {"recurrentgemma-9b": dict(LIMITS, logits=2.0 ** -6,
                                         state=1e-3)}


def _hold_cache(got, want, what, limits) -> float:
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g["mixer"]) == set(w["mixer"]), what
        for name, leaf in w["mixer"].items():
            mine = g["mixer"][name]
            assert mine.shape == leaf.shape and mine.dtype == leaf.dtype, \
                (what, i, name)
            if name == "kpos":
                np.testing.assert_array_equal(mine, leaf,
                                              err_msg=f"{what} {i} kpos")
                continue
            err = _rel(mine, leaf)
            assert err <= limits[name], (what, i, name, err)
            worst = max(worst, err)
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serving_matches_one_process(runs, one_process, arch):
    """The prefill (4 rows of 62 tokens; h2o's and recurrentgemma's
    attention at a window of 64 into a ring of 64 slots) and three
    decode steps on the (2, 2) gloo mesh against the same run in one
    process: every rank reports the same arrays; each step's logits
    within one bf16 rounding (2^-7) of their largest magnitude, the
    ``k`` / ``v`` / ``conv`` leaves likewise, the SSD's float32 states
    within 1e-4 of theirs, ``kpos`` exact (after the third step the
    windowed archs' slot 0 holds position 64).  The mesh rounds its
    float32 partial sums over ``model`` to bf16 once, after their
    reduction, as one process rounds each bf16 product's float32 sum
    once, but in another order: a few entries of a block's output round
    one bf16 step apart (measured: logits within 5.8e-3, 4.9e-3 and
    4.5e-3 of their largest magnitude for smollm, h2o and mamba2, whose
    decoded states are equal).  recurrentgemma's RG-LRU carries each
    such step along the sequence: its first block's output differs from
    one process's in 0.27 % of the entries, its third's in 15.7 %, its
    prefill logits by 9.0e-3 of their largest magnitude and its second
    RG-LRU state by 1.35e-4 (its first's by 1.7e-6), so it is held to
    two bf16 roundings (2^-6) and 1e-3; the reference's own scanned and
    eager runs differ by up to 0.059 in its bf16 logits
    (``test_torch_models.py``, ``UNROLLED``)."""
    reps = runs["reps"]
    assert all(_same(r[arch], reps[0][arch]) for r in reps[1:])
    got, want = reps[0][arch], one_process[arch]
    limits = ARCH_LIMITS.get(arch, LIMITS)
    worst_l = worst_c = 0.0
    for step, (gl, wl, gc, wc) in enumerate(zip(
            got["logits"], want["logits"], got["cache"], want["cache"])):
        assert gl.shape == wl.shape
        err = _rel(gl, wl)
        assert err <= limits["logits"], (arch, step, err)
        worst_l = max(worst_l, err)
        worst_c = max(worst_c, _hold_cache(gc, wc, f"{arch} step {step}",
                                           limits))
    cfg = runs["job"][arch][0]
    if cfg.window is not None:
        kpos = got["cache"][-1][cfg.pattern.index("attn")]["mixer"]["kpos"]
        assert (kpos[:, 0] == SEQ + STEPS - 1).all() and \
            (kpos[:, 1:SEQ] == np.arange(1, SEQ)).all()
    print(f"\n{arch}: logits {worst_l:.3e}, cache {worst_c:.3e} of their "
          f"largest magnitudes")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_mesh_is_the_meshless_port(runs, arch):
    """On a (1, 1) mesh (a one-rank gloo group) the prefill and three
    decode steps are the meshless run's bit for bit, logits and cache:
    a spec on a mesh dim of one device places nothing
    (``common.placements`` gives ``Replicate()``; a single kv head
    "sharded" one way made DTensor refuse the reshape of recurrentgemma's
    ``wk``), and a residual branch's product is float32 only where a mesh
    dim of more than one device splits it (``layers.branch_out``)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import place_params
    ns: dict = {}
    exec(SERVE_RUN, ns)
    cfg, tree, tokens, slots, steps, _, _ = runs["job"][arch]
    want = ns["serve"](cfg, params_from_numpy(cfg, tree, device="cpu"),
                       tokens, slots, steps, None)
    mesh = make_host_mesh(1, 1, device_type="cpu")
    model = place_params(params_from_numpy(cfg, tree, device="cpu"), mesh)
    got = ns["serve"](cfg, model, tokens, slots, steps, mesh)
    assert _same(got, want)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v3-671b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_queued_families_raise_on_a_mesh(arch):
    """The MoE / MLA and memory-input families' prefill on a mesh raises,
    naming the ROADMAP step that queues it; their training there runs
    (``test_torch_moe_mesh.py``, ``test_torch_memory_mesh.py``)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    cfg = get_arch(arch).reduced()
    bundle = build(cfg)
    model = bundle.init(0, "cpu")
    mesh = make_host_mesh(1, 1, device_type="cpu")
    with pytest.raises(NotImplementedError, match="step 3b"):
        bundle.prefill(model, torch.zeros((1, 8), dtype=torch.long),
                       mesh=mesh)


def _solo(bundle, model, prompt, toks):
    logits, cache = bundle.prefill(model, torch.from_numpy(prompt[None])
                                   .long(), cache_slots=MAX_LEN)
    rows = [logits[0, -1]]
    for i, t in enumerate(toks[:-1]):
        pos = torch.full((1, 1), len(prompt) + i)
        logits, cache = bundle.decode_step(model, cache,
                                           torch.tensor([[t]]), pos)
        rows.append(logits[0, 0])
    return torch.stack(rows).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_engine_matches_one_process(runs, arch):
    """``Engine(mesh=)`` on the (2, 2) gloo mesh serves five prompts in
    batches of 4 (the decode rows split over "data") and 1 (replicated):
    every rank emits the same tokens, each within 0.05 of the max logit
    of the one-process solo teacher-forced run (the reference's rule,
    ``test_torch_serve.py``)."""
    from repro_torch.models import build
    reps = runs["reps"]
    toks = reps[0][arch]["engine"]
    assert all(r[arch]["engine"] == toks for r in reps[1:])
    cfg, tree, *_, prompts, _ = runs["job"][arch]
    model = params_from_numpy(cfg, tree, device="cpu")
    bundle = build(cfg)
    for (prompt, max_new), got in zip(prompts, toks):
        assert len(got) == max_new
        solo = _solo(bundle, model, prompt, got)
        for i, t in enumerate(got):
            gap = solo[i].max() - solo[i][t]
            assert gap <= GAP, f"{arch} step {i}: token {t} gap {gap:.4f}"


# the one-process run's limit against the reference (see the test)
REF_TOL = {"recurrentgemma-9b": 6e-2}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_serving_matches_reference(runs, one_process, arch):
    """The one-process run against the reference's ``prefill`` and
    ``decode_step`` (called eagerly, unrolled) on the same weights and
    tokens under the model tests' limit (3e-2, ``test_torch_models.py``):
    each step's logits and the whole cache after the prefill and after
    the last step (``kpos`` exact).  recurrentgemma's at 6e-2, the
    reference's own spread between its scanned and its eager runs (0.059
    in bf16 logits, ``test_torch_models.py``): at these 4 rows of 62
    tokens one of its 126,976 prefill logits lies 0.0332 from the
    reference's (the model tests hold one row of 12)."""
    import jax.numpy as jnp
    from repro import configs as rcfgs
    from repro.models import build as jbuild
    from repro.models import unbox
    import jax

    cfg, tree, tokens, slots, steps, _, _ = runs["job"][arch]
    rcfg = _cfg(rcfgs, arch)
    jb = jbuild(rcfg)
    params = unbox(jb.init(jax.random.key(0)))
    s = tokens.shape[1] - steps
    lj, cj = jb.prefill(params, jnp.asarray(tokens[:, :s]), cache_slots=slots)
    mine = one_process[arch]
    want = [np.asarray(lj, np.float32)]
    caches = [cj]
    for i in range(steps):
        pos = jnp.full((tokens.shape[0], 1), s + i, jnp.int32)
        lj, cj = jb.decode_step(params, cj,
                                jnp.asarray(tokens[:, s + i:s + i + 1]), pos)
        want.append(np.asarray(lj, np.float32))
        caches.append(cj)
    tol = REF_TOL.get(arch, 3e-2)
    for step, (g, w) in enumerate(zip(mine["logits"], want)):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                   err_msg=f"{arch} step {step} logits")
    for step in (0, steps):
        port = cache_to_numpy(cfg, _as_tensors(mine["cache"][step]))
        _close_tree(port, caches[step], f"{arch} step {step} cache", tol)


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tensors(v) for v in tree]
    return torch.from_numpy(tree)


def _close_tree(got, want, what, tol):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for key in want:
            _close_tree(got[key], want[key], f"{what}.{key}", tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, f"{what}[{i}]", tol)
    elif what.endswith("kpos"):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol, err_msg=what)


class _StandIn:
    """The reference's view of a mesh: axis names and a device array."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_are_the_references(arch, mesh_name):
    """``cache_specs`` of the port's ``cache_shapes`` at the published
    width, for ``decode_32k``'s cache (128 rows, min(32,768, window)
    slots), against the reference's ``cache_logical_axes`` resolved by
    its ``resolve_specs`` on a stand-in mesh, leaf by leaf, over its
    ``jax.eval_shape`` of a prefill into that cache (its scanned layers
    stacked: a body leaf's spec drops the layer dim's leading None);
    the leaves' shapes and dtypes are the reference's too."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as ref_get_arch
    from repro.models import build as jbuild
    from repro.models import cache_logical_axes as ref_axes
    from repro.models import unbox
    from repro.models.common import DEFAULT_RULES as REF_RULES
    from repro.models.common import resolve_specs as ref_resolve
    from repro.models.transformer import layer_plan as ref_plan
    from repro_torch.configs import get_arch
    from repro_torch.models import build, cache_specs

    shape, names = MESHES[mesh_name]
    stand_in = _StandIn(shape, names)
    rcfg = ref_get_arch(arch)
    ctx = 32768 if rcfg.window is None else min(32768, rcfg.window)
    jb = jbuild(rcfg)
    params = unbox(jb.abstract_params())
    _, ref_cache = jax.eval_shape(
        lambda p, t: jb.prefill(p, t, cache_slots=ctx), params,
        jax.ShapeDtypeStruct((128, ctx), jnp.int32))
    ref_specs = ref_resolve(ref_axes(ref_cache), REF_RULES, stand_in,
                            jax.tree.map(lambda l: tuple(l.shape),
                                         ref_cache))
    plan = ref_plan(rcfg)
    flat = {}

    def walk(layer, node, spec, stacked):
        for key, sub in node["mixer"].items():
            s = tuple(spec["mixer"][key])
            sh = tuple(sub.shape)
            flat[(layer, key)] = (s[1:] if stacked else s,
                                  sh[1:] if stacked else sh, sub.dtype)

    for i, c in enumerate(ref_cache["prefix"]):
        walk(i, c, ref_specs["prefix"][i], False)
    for r in range(plan.reps):
        for j in range(plan.period):
            walk(plan.prefix + r * plan.period + j,
                 ref_cache["body"][f"pos{j}"], ref_specs["body"][f"pos{j}"],
                 True)
    base = plan.prefix + plan.reps * plan.period
    for i, c in enumerate(ref_cache.get("suffix", [])):
        walk(base + i, c, ref_specs["suffix"][i], False)

    cfg = get_arch(arch)
    port = build(cfg).cache_shapes(128, ctx)
    specs = cache_specs(port, stand_in)
    got = {(i, key): (tuple(specs[i]["mixer"][key]), tuple(t.shape),
                      str(t.dtype).rsplit(".", 1)[-1])
           for i, layer in enumerate(port) for key, t in
           layer["mixer"].items()}
    want = {k: (s, sh, str(jnp.dtype(dt))) for k, (s, sh, dt) in
            flat.items()}
    assert got == want
