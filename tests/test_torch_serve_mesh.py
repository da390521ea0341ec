"""Serving on a mesh: the prefill and decode of every family under a
``DeviceMesh``, ``Engine(mesh=)``, and the caches' specs against the
reference's.

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
``convert.params_from_numpy``).

The MoE / MLA and memory-input families (reduced granite-moe-3b-a800m
and deepseek-v3-671b at a capacity factor of E / k, which drops no pick;
llama-3.2-vision-90b at ``reduced().replace(n_layers=10)``, since
``reduced()`` keeps no cross layer; seamless-m4t-large-v2; every cross
gate at 1.0) serve 6 rows of 62 tokens with a seeded memory (16 image
tokens, or 15 frames through the encoder): 6 x 62 tokens divide over the
4 devices, so the MoE prefill takes the all-to-all path, and a decode
step's 6 do not, so it takes the global scatter path."""

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
# the MoE / MLA and memory-input families
FAMILIES = ("granite-moe-3b-a800m", "deepseek-v3-671b",
            "llama-3.2-vision-90b", "seamless-m4t-large-v2")
# the prefill's rows and tokens, the decode steps after it; FAMILIES'
# rows (6: a decode step's tokens do not divide over 4 devices)
ROWS, SEQ, STEPS = 4, 62, 3
FAMILY_ROWS = 6
# the engine's queue: five prompts of 3 to 9 tokens, 6 new tokens each
PROMPTS, MAX_NEW, MAX_LEN, MAX_BATCH = 5, 6, 64, 4
GAP = 0.05


def _cfg(mod, arch):
    """The reduced config of ``arch`` from the configs module ``mod``
    (the reference's or the port's), unrolled; vision at ten layers (two
    cross layers); a MoE config at the capacity factor E / k, at which
    no bin overflows (each token picks an expert at most once), as the
    one-process route never drops."""
    import dataclasses
    cfg = mod.get_arch(arch).reduced().replace(scan_layers=False)
    if cfg.vision is not None:
        cfg = cfg.replace(n_layers=10)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _memory_len(cfg) -> int:
    """The memory's rows: 16 image tokens, or 15 frames, else 0."""
    return 16 if cfg.vision is not None else \
        15 if cfg.encoder is not None else 0


def _memory(cfg, rows: int, seed: int = 5):
    n = _memory_len(cfg)
    return np.random.default_rng(seed).normal(
        size=(rows, n, cfg.d_model)).astype(np.float32) if n else None


def _slots(cfg) -> int:
    """The prefill's cache slots: a windowed arch's window (its ring
    wraps at the third decode step), else room for every step."""
    return cfg.window or SEQ + STEPS + 1


def _gates_at_one(tree):
    if isinstance(tree, dict):
        return {k: (np.ones_like(v) if k == "gate" else _gates_at_one(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_gates_at_one(v) for v in tree]
    return tree


def _ref_tree(arch) -> dict:
    """The reference's initial weights (key 0), every cross gate at 1.0:
    both inits leave it at zero, and tanh(0) would hide the cross
    layers."""
    import jax
    from repro import configs as rcfgs
    from repro.models import build as jbuild
    from repro.models import unbox
    return _gates_at_one(jax.tree.map(np.asarray, unbox(
        jbuild(_cfg(rcfgs, arch)).init(jax.random.key(0)))))


def _rows(arch) -> int:
    return FAMILY_ROWS if arch in FAMILIES else ROWS


def _tokens(cfg, rows: int, seed: int = 3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (rows, SEQ + STEPS)).astype(np.int32)


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
    def serve(cfg, model, tokens, slots, steps, mesh, memory=None):
        # a prefill of tokens[:, :-steps] (with the memory, where given),
        # then one teacher-forced decode step per remaining token: each
        # step's logits and whole cache
        import numpy as np
        import torch
        from repro_torch.models import build
        bundle = build(cfg)
        mem = None if memory is None else torch.from_numpy(memory)
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
                                       memory=mem, **kw)
        out = {"logits": [host(logits)], "cache": [host(cache)]}
        for i in range(steps):
            pos = torch.full((tok.shape[0], 1), s + i)
            logits, cache = bundle.decode_step(
                model, cache, tok[:, s + i:s + i + 1], pos, **kw)
            out["logits"].append(host(logits))
            out["cache"].append(host(cache))
        return out

    def record_picks(force=None):
        # wraps moe.router_topk: every call's top-k picks in ``calls``;
        # with ``force`` (the picks of each call), the call takes those
        # picks, weighted by its own probabilities renormalised; returns
        # (calls, undo)
        import torch
        from repro_torch.models import moe
        calls, orig = [], moe.router_topk

        def topk(cfg, logits):
            probs, top_w, top_idx = orig(cfg, logits)
            calls.append(top_idx.clone())
            if force is not None:
                top_idx = torch.as_tensor(force[len(calls) - 1])
                w = probs.gather(-1, top_idx)
                top_w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
            return probs, top_w, top_idx
        moe.router_topk = topk
        return calls, lambda: setattr(moe, "router_topk", orig)
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
    for arch, (cfg, tree, tokens, slots, steps, prompts, scfg, memory) in \\
            job.items():
        model = place_params(params_from_numpy(cfg, tree, device="cpu"),
                             mesh)
        calls, undo = record_picks()
        out[arch] = serve(cfg, model, tokens, slots, steps, mesh, memory)
        undo()
        out[arch]["picks"] = [c.numpy() for c in calls]
        eng = Engine(cfg, model, ServeConfig(**scfg), device="cpu",
                     mesh=mesh)
        rids = [eng.submit(p, max_new=max_new) for p, max_new in prompts]
        res = eng.run(memory=None if memory is None else memory[:1])
        out[arch]["engine"] = [res[r] for r in rids]
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's report of :data:`GLOO`, and each arch's (cfg,
    weights, tokens, slots, steps, prompts, serve config, memory)."""
    from repro_torch import configs as tcfgs
    tmp = tmp_path_factory.mktemp("serve_mesh")
    job = {}
    for arch in ARCHS + FAMILIES:
        cfg = _cfg(tcfgs, arch)
        job[arch] = (cfg, _ref_tree(arch), _tokens(cfg, _rows(arch)),
                     _slots(cfg), STEPS,
                     [(p, MAX_NEW) for p in _prompts(cfg)],
                     dict(max_batch=MAX_BATCH, max_len=MAX_LEN),
                     _memory(cfg, _rows(arch)))
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


def _float32_route(self, x2d, top_w, top_idx):
    """The one-process MoE layer through the mesh paths' float32 experts
    (``moe.expert_mlp``) at a capacity of T rows a bin, in place of the
    one-card route's experts in the activation dtype: the all-to-all and
    scatter paths run the reference's ``_expert_mlp_any``, in float32
    (``tests/test_torch_moe_mesh.py`` holds its steps so)."""
    from repro_torch.models import moe as tmoe
    t = x2d.shape[0]
    e = self.cfg.moe.n_experts
    slot, keep = tmoe.slot_rule(top_idx, e, t)
    bins, index = tmoe.dispatch(x2d, top_idx, slot, keep, e, t)
    y = tmoe.expert_mlp(bins, self.w_gate, self.w_up, self.w_down)
    return tmoe.combine(y.to(x2d.dtype), index, top_w, keep)


def _mesh_picks(reps, arch, rows: int):
    """The mesh run's top-k picks of each MoE router call in the global
    token order (rows, then positions): a prefill's all-to-all calls
    hold each device's block of 3D tokens (rows over "data", positions
    over "model", rank = 2 data + model), a decode step's scatter calls
    every token, the same on every rank."""
    out = []
    for i, first in enumerate(reps[0][arch]["picks"]):
        if first.shape[0] == rows:
            assert all(np.array_equal(r[arch]["picks"][i], first)
                       for r in reps[1:])
            out.append(first)
            continue
        k = first.shape[1]
        whole = np.zeros((rows, SEQ, k), first.dtype)
        r_loc, s_loc = rows // 2, SEQ // 2
        for rank, rep in enumerate(reps):
            d, m = divmod(rank, 2)
            whole[d * r_loc:(d + 1) * r_loc, m * s_loc:(m + 1) * s_loc] = \
                rep[arch]["picks"][i].reshape(r_loc, s_loc, k)
        out.append(whole.reshape(rows * SEQ, k))
    return out


@pytest.fixture(scope="module")
def one_process(runs):
    """The same prefill and decode steps of each arch in one process (a
    MoE layer's experts in float32, :func:`_float32_route`, and its
    router taking the mesh run's picks, :func:`_mesh_picks`; each call's
    own picks are kept under ``"picks"`` with its probabilities under
    ``"probs"``)."""
    from repro_torch.models import moe as tmoe
    ns: dict = {}
    exec(SERVE_RUN, ns)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmoe.MoE, "route", _float32_route)
        probs = []
        orig = tmoe.router_topk

        def topk(cfg, logits):
            res = orig(cfg, logits)
            probs.append(res[0].numpy())
            return res
        mp.setattr(tmoe, "router_topk", topk)
        for arch, (cfg, tree, tokens, slots, steps, _, _, memory) in \
                runs["job"].items():
            model = params_from_numpy(cfg, tree, device="cpu")
            probs.clear()
            force = None if cfg.moe is None else _mesh_picks(
                runs["reps"], arch, tokens.shape[0])
            calls, undo = ns["record_picks"](force)
            out[arch] = ns["serve"](cfg, model, tokens, slots, steps, None,
                                    memory)
            undo()
            out[arch]["picks"] = [c.numpy() for c in calls]
            out[arch]["probs"] = list(probs)
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
# two roundings and its RG-LRU states 1e-3, deepseek's logits and
# vision's logits and self-attention k and v two roundings (see the
# test's docstring)
LIMITS = {"logits": 2.0 ** -7, "k": 2.0 ** -7, "v": 2.0 ** -7,
          "conv": 2.0 ** -7, "state": 1e-4, "ckv": 2.0 ** -7,
          "krope": 2.0 ** -7, "enc_memory": 2.0 ** -7}
ARCH_LIMITS = {"recurrentgemma-9b": dict(LIMITS, logits=2.0 ** -6,
                                         state=1e-3),
               "deepseek-v3-671b": dict(LIMITS, logits=2.0 ** -6),
               "llama-3.2-vision-90b": dict(LIMITS, logits=2.0 ** -6,
                                            k=2.0 ** -6, v=2.0 ** -6)}


def _layers(cache):
    return cache["layers"] if isinstance(cache, dict) else cache


def _hold_cache(got, want, what, limits) -> float:
    worst = 0.0
    if isinstance(want, dict):
        assert set(got) == set(want) == {"layers", "enc_memory"}, what
        err = _rel(got["enc_memory"], want["enc_memory"])
        assert got["enc_memory"].shape == want["enc_memory"].shape
        assert err <= limits["enc_memory"], (what, "enc_memory", err)
        worst = err
    for i, (g, w) in enumerate(zip(_layers(got), _layers(want))):
        assert set(g) == set(w), what
        for part in w:
            assert set(g[part]) == set(w[part]), (what, i, part)
            for name, leaf in w[part].items():
                mine = g[part][name]
                assert mine.shape == leaf.shape and \
                    mine.dtype == leaf.dtype, (what, i, part, name)
                if name == "kpos":
                    np.testing.assert_array_equal(
                        mine, leaf, err_msg=f"{what} {i} {part} kpos")
                    continue
                err = _rel(mine, leaf)
                assert err <= limits[name], (what, i, part, name, err)
                worst = max(worst, err)
    return worst


@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_mesh_serving_matches_one_process(runs, one_process, arch):
    """The prefill (4 rows of 62 tokens; h2o's and recurrentgemma's
    attention at a window of 64 into a ring of 64 slots; the MoE / MLA
    and memory-input families 6 rows with their memory) and three
    decode steps on the (2, 2) gloo mesh against the same run in one
    process: every rank reports the same arrays; each step's logits
    within one bf16 rounding (2^-7) of their largest magnitude, the
    ``k`` / ``v`` / ``conv`` / ``ckv`` / ``krope`` / ``enc_memory``
    leaves likewise, the SSD's float32 states within 1e-4 of theirs,
    ``kpos`` exact (after the third step the windowed archs' slot 0 holds
    position 64).  The mesh rounds its float32 partial sums over
    ``model`` to bf16 once, after their reduction, as one process rounds
    each bf16 product's float32 sum once, but in another order: a few
    entries of a block's output round one bf16 step apart (measured:
    logits within 5.8e-3, 4.9e-3 and 4.5e-3 of their largest magnitude
    for smollm, h2o and mamba2, whose decoded states are equal).
    recurrentgemma's RG-LRU carries each such step along the sequence:
    its first block's output differs from one process's in 0.27 % of
    the entries, its third's in 15.7 %, its prefill logits by 9.0e-3 of
    their largest magnitude and its second RG-LRU state by 1.35e-4 (its
    first's by 1.7e-6), so it is held to two bf16 roundings (2^-6) and
    1e-3; the reference's own scanned and eager runs differ by up to
    0.059 in its bf16 logits (``test_torch_models.py``, ``UNROLLED``).
    The one process runs a MoE layer's experts in float32, as the mesh
    paths do (:func:`_float32_route`), and its router takes the mesh's
    picks (:func:`_hold_picks` holds them against its own): granite is
    then bit for bit, logits and cache.  deepseek's router logits are
    bf16 products of bf16 weights and tie often; one bf16 step upstream
    (MLA's heads, the shared expert's and the dense layer's partial sums
    split over ``model``) tipped 2 of its 780 tokens' ties (measured),
    and its logits lie within 8.0e-3.  Over vision's ten bf16-weight
    layers the steps add up as along recurrentgemma's sequence: its
    self-attention k and v differ in 0.15 % of the entries at the second
    layer and 24 % at the ninth, by up to 8.2e-3 of their largest
    magnitude, its logits by 1.08e-2.  deepseek's and vision's logits and
    vision's k and v are held to 2^-6, every other leaf to 2^-7."""
    reps = runs["reps"]
    assert all(_same(r[arch]["logits"], reps[0][arch]["logits"])
               and _same(r[arch]["cache"], reps[0][arch]["cache"])
               for r in reps[1:])
    got, want = reps[0][arch], one_process[arch]
    limits = ARCH_LIMITS.get(arch, LIMITS)
    cfg = runs["job"][arch][0]
    flips = ""
    if cfg.moe is not None:
        flips = _hold_picks(arch, cfg, _mesh_picks(reps, arch,
                                                   got["logits"][0].shape[0]),
                            want)
    worst_l = worst_c = 0.0
    for step, (gl, wl, gc, wc) in enumerate(zip(
            got["logits"], want["logits"], got["cache"], want["cache"])):
        assert gl.shape == wl.shape
        err = _rel(gl, wl)
        assert err <= limits["logits"], (arch, step, err)
        worst_l = max(worst_l, err)
        worst_c = max(worst_c, _hold_cache(gc, wc, f"{arch} step {step}",
                                           limits))
    if cfg.window is not None:
        kpos = got["cache"][-1][cfg.pattern.index("attn")]["mixer"]["kpos"]
        assert (kpos[:, 0] == SEQ + STEPS - 1).all() and \
            (kpos[:, 1:SEQ] == np.arange(1, SEQ)).all()
    print(f"\n{arch}: logits {worst_l:.3e}, cache {worst_c:.3e} of their "
          f"largest magnitudes{flips}")


# a pick of the mesh run that one process's router does not make must lie
# within this share of the k-th largest probability (see the test)
TIE = 2.0 ** -5


def _hold_picks(arch, cfg, mesh_picks, want) -> str:
    """The mesh run's MoE picks against one process's own (the router of
    the one-process run, fed the mesh's picks upstream): the same calls,
    and each pick the mesh makes that one process does not is tied there
    with its k-th pick, within :data:`TIE` of its probability, both ways
    (a bf16 router's logits tie often: one bf16 step of its input, from
    partial sums added in another order, tips a tie).  Returns a note of
    the flips for the printout."""
    k = cfg.moe.top_k
    assert len(mesh_picks) == len(want["picks"]) == len(want["probs"])
    n = flipped = 0
    worst = 0.0
    for mine, own, probs in zip(mesh_picks, want["picks"], want["probs"]):
        assert mine.shape == own.shape
        n += own.shape[0]
        for t in np.nonzero((np.sort(mine, 1) != np.sort(own, 1)).any(1))[0]:
            flipped += 1
            kth = np.sort(probs[t])[::-1][k - 1]
            for e in set(mine[t]) ^ set(own[t]):
                gap = abs(probs[t][e] - kth) / kth
                assert gap <= TIE, (arch, t, e, gap)
                worst = max(worst, gap)
    assert flipped <= n // 20, (arch, flipped, n)
    return f"; {flipped} of {n} tokens' picks tipped at ties (gap {worst:.2e})"


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
    cfg, tree, tokens, slots, steps, _, _, _ = runs["job"][arch]
    want = ns["serve"](cfg, params_from_numpy(cfg, tree, device="cpu"),
                       tokens, slots, steps, None)
    mesh = make_host_mesh(1, 1, device_type="cpu")
    model = place_params(params_from_numpy(cfg, tree, device="cpu"), mesh)
    got = ns["serve"](cfg, model, tokens, slots, steps, mesh)
    assert _same(got, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_queued_families_raise_on_a_mesh(runs, arch):
    """The MoE / MLA and memory-input families, no longer queued, serve
    on a (1, 1) mesh (a one-rank gloo group) bit for bit as without a
    mesh: the prefill with its memory and three decode steps, logits and
    cache (the MoE layer takes the one-card route on the local tensors,
    as the reference's ``apply_moe`` takes its meshless route on one
    device; MLA's and the cross layers' kernels and caches run on the
    one device's whole blocks)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import place_params
    ns: dict = {}
    exec(SERVE_RUN, ns)
    cfg, tree, tokens, slots, steps, _, _, memory = runs["job"][arch]
    want = ns["serve"](cfg, params_from_numpy(cfg, tree, device="cpu"),
                       tokens, slots, steps, None, memory)
    mesh = make_host_mesh(1, 1, device_type="cpu")
    model = place_params(params_from_numpy(cfg, tree, device="cpu"), mesh)
    got = ns["serve"](cfg, model, tokens, slots, steps, mesh, memory)
    assert _same(got, want)


def _solo(bundle, model, prompt, toks, memory=None):
    mem = None if memory is None else torch.from_numpy(memory[:1])
    logits, cache = bundle.prefill(model, torch.from_numpy(prompt[None])
                                   .long(), cache_slots=MAX_LEN, memory=mem)
    rows = [logits[0, -1]]
    for i, t in enumerate(toks[:-1]):
        pos = torch.full((1, 1), len(prompt) + i)
        logits, cache = bundle.decode_step(model, cache,
                                           torch.tensor([[t]]), pos)
        rows.append(logits[0, 0])
    return torch.stack(rows).numpy()


@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_mesh_engine_matches_one_process(runs, arch):
    """``Engine(mesh=)`` on the (2, 2) gloo mesh serves five prompts in
    batches of 4 (the decode rows split over "data") and 1 (replicated),
    a memory config's every prefill with the first row's memory: every
    rank emits the same tokens, each within 0.05 of the max logit of the
    one-process solo teacher-forced run (the reference's rule,
    ``test_torch_serve.py``)."""
    from repro_torch.models import build
    reps = runs["reps"]
    toks = reps[0][arch]["engine"]
    assert all(r[arch]["engine"] == toks for r in reps[1:])
    cfg, tree, *_, prompts, _, memory = runs["job"][arch]
    model = params_from_numpy(cfg, tree, device="cpu")
    bundle = build(cfg)
    for (prompt, max_new), got in zip(prompts, toks):
        assert len(got) == max_new
        solo = _solo(bundle, model, prompt, got, memory)
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

    cfg, tree, tokens, slots, steps, _, _, _ = runs["job"][arch]
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
@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_cache_specs_are_the_references(arch, mesh_name):
    """``cache_specs`` of the port's ``cache_shapes`` at the published
    width, for ``decode_32k``'s cache (128 rows, min(32,768, window)
    slots; a memory config's cross layers and ``enc_memory`` at the dry
    run's memory, 1,600 image tokens or 8,192 frames), against the
    reference's ``cache_logical_axes`` resolved by its ``resolve_specs``
    on a stand-in mesh, leaf by leaf, over its ``jax.eval_shape`` of a
    prefill into that cache (its scanned layers stacked: a body leaf's
    spec drops the layer dim's leading None); the leaves' shapes and
    dtypes are the reference's too (MLA's ``ckv`` / ``krope``, the cross
    layers' ``k`` / ``v`` without ``kpos``)."""
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
    from repro_torch.launch.dryrun import memory_tokens
    from repro_torch.models import build, cache_specs

    shape, names = MESHES[mesh_name]
    stand_in = _StandIn(shape, names)
    rcfg = ref_get_arch(arch)
    ctx = 32768 if rcfg.window is None else min(32768, rcfg.window)
    n_mem = memory_tokens(get_arch(arch), 32768)
    jb = jbuild(rcfg)
    params = unbox(jb.abstract_params())
    mem = jax.ShapeDtypeStruct((128, n_mem, rcfg.d_model), jnp.bfloat16) \
        if n_mem else None
    _, ref_cache = jax.eval_shape(
        lambda p, t, m: jb.prefill(p, t, memory=m, cache_slots=ctx), params,
        jax.ShapeDtypeStruct((128, ctx), jnp.int32), mem)
    ref_specs = ref_resolve(ref_axes(ref_cache), REF_RULES, stand_in,
                            jax.tree.map(lambda l: tuple(l.shape),
                                         ref_cache))
    plan = ref_plan(rcfg)
    flat = {}

    def walk(layer, node, spec, stacked):
        for part, leaves in node.items():
            for key, sub in leaves.items():
                s_ = tuple(spec[part][key])
                sh = tuple(sub.shape)
                flat[(layer, part, key)] = (s_[1:] if stacked else s_,
                                            sh[1:] if stacked else sh,
                                            sub.dtype)

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
    if n_mem:
        e = ref_cache["enc_memory"]
        flat["enc_memory"] = (tuple(ref_specs["enc_memory"]), tuple(e.shape),
                              e.dtype)

    cfg = get_arch(arch)
    port = build(cfg).cache_shapes(128, ctx, n_mem or None)
    specs = cache_specs(port, stand_in)
    dt = lambda t: str(t.dtype).rsplit(".", 1)[-1]
    got = {(i, part, key): (tuple(specs_l[part][key]), tuple(t.shape), dt(t))
           for i, (layer, specs_l) in enumerate(zip(_layers(port),
                                                    _layers(specs)))
           for part, leaves in layer.items() for key, t in leaves.items()}
    if n_mem:
        e = port["enc_memory"]
        got["enc_memory"] = (tuple(specs["enc_memory"]), tuple(e.shape),
                             dt(e))
    want = {k: (s_, sh, str(jnp.dtype(d))) for k, (s_, sh, d) in
            flat.items()}
    assert got == want
