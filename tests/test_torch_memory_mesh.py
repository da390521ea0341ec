"""The RG-LRU block, the cross layers and the encoder of the port under a
mesh, against the port's one-process runs and the reference on the CPU.

Reduced recurrentgemma-9b (rglru, rglru, attn; sequence parallel),
llama-3.2-vision-90b at ten layers (two gated cross layers; reduced()
keeps four and none) and seamless-m4t-large-v2 (two encoder layers, two
decoder layers with cross-attention) run over 4 gloo processes on a
(2, 2) ("data", "model") mesh: their blocks' outputs and input
gradients, two sharded train steps each, and the trainer on the mesh,
held against the same runs in one process.  Every cross ``gate`` is set
to 1.0 on both sides first: both packages start it at zero, and tanh(0)
shuts the memory out of any comparison.  The weights are the reference's
initial ones (key 0, unrolled: ``scan_layers=False``), through
``convert.params_from_numpy``.  The reference's sharded steps (its
``make_train_step`` on an Auto-axis (2, 2) mesh of 4 host devices) run
under ``-m slow``."""

from __future__ import annotations

import json
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

from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.train import make_train_step, train_state_from_model

SRC = Path(__file__).resolve().parents[1] / "src"
RGEMMA, VISION, SEAMLESS = ("recurrentgemma-9b", "llama-3.2-vision-90b",
                            "seamless-m4t-large-v2")
ARCHS = (RGEMMA, VISION, SEAMLESS)
# vision with one kv head: its 4 q heads split over the 2-way model axis
# and the kv head replicated, as llama-3.2-vision-90b's 8 kv heads are on
# the 16-way axis (``layers.kv_heads_read``); a block case only
VISION_KV1 = f"{VISION}/kv1"
VARIANTS = {VISION_KV1: (VISION, {"n_kv_heads": 1})}
# the steps' batch: 4 rows of 32 tokens; the memory's length a row
ROWS, SEQ = 4, 32
# the block each case's block test runs: the first RG-LRU block, the
# first cross layer (layer 4 of vision's ten), seamless's encoder
BLOCKS = {RGEMMA: 0, VISION: 4, SEAMLESS: "encoder", VISION_KV1: 4}


def _cfg(mod, arch):
    """The reduced config of ``arch`` (or of a :data:`VARIANTS` case) from
    the configs module ``mod`` (the reference's or the port's),
    unrolled; vision at ten layers."""
    arch, kw = VARIANTS.get(arch, (arch, {}))
    cfg = mod.get_arch(arch).reduced().replace(scan_layers=False, **kw)
    return cfg.replace(n_layers=10) if arch == VISION else cfg


def _memory_tokens(cfg) -> int:
    if cfg.vision is not None:
        return cfg.vision.n_image_tokens
    if cfg.encoder is not None:
        return SEQ // cfg.encoder.frame_ratio
    return 0


def _gates_at_one(tree):
    if isinstance(tree, dict):
        return {k: (np.ones_like(v) if k == "gate" else _gates_at_one(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_gates_at_one(v) for v in tree]
    return tree


def _ref_tree(arch) -> dict:
    """The reference's initial weights (key 0) as numpy arrays, every
    cross gate at 1.0."""
    import jax
    from repro import configs as rcfgs
    from repro.models import build as jbuild
    from repro.models import unbox
    return _gates_at_one(jax.tree.map(np.asarray, unbox(
        jbuild(_cfg(rcfgs, arch)).init(jax.random.key(0)))))


def _batch(cfg, seed: int = 1) -> dict:
    """Seeded tokens (ROWS, SEQ) and, for a memory-input config, a
    memory (ROWS, T, M) uniform in [-1, 1) as the data pipeline's."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (ROWS, SEQ))}
    t = _memory_tokens(cfg)
    if t:
        out["memory"] = rng.uniform(-1.0, 1.0, (ROWS, t, cfg.d_model)) \
            .astype(np.float32)
    return out


def _block_input(cfg, seed: int = 2):
    """(x (ROWS, SEQ, M), the block's memory or None, dy) float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(ROWS, SEQ, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    mem = _batch(cfg).get("memory")
    if cfg.encoder is not None:
        x = mem
        dy = rng.normal(size=mem.shape).astype(np.float32)
        mem = None
    return x, mem, dy


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


def _last_json(text: str):
    return json.loads(text.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# The port's runs over 4 gloo processes
# ---------------------------------------------------------------------------

BLOCK_RUN = textwrap.dedent("""
    def run_block(cfg, model, key, x, mem, dy, mesh):
        # the block (or the encoder) of BLOCKS[key] on x, forward and
        # backward against dy: (y, dx) as float32 arrays
        import torch
        from repro_torch.models.layers import rope_table
        leaf = torch.from_numpy(x).bfloat16()
        if mesh is not None:
            from torch.distributed.tensor import Replicate, Shard, \\
                distribute_tensor
            leaf = distribute_tensor(leaf, mesh, [Shard(0), Replicate()])
        leaf.requires_grad_(True)
        memory = None
        if mem is not None:
            memory = torch.from_numpy(mem).bfloat16()
            if mesh is not None:
                memory = distribute_tensor(memory, mesh,
                                           [Shard(0), Replicate()])
        if key == "encoder":
            y = model.encoder(leaf, mesh=mesh)
        else:
            block = model.blocks[key]
            pos = torch.arange(x.shape[1])
            tab = None
            if mesh is not None and "attn" in cfg.pattern:
                from repro_torch.models.layers import replicated
                tab = tuple(replicated(t, mesh) for t in rope_table(
                    pos, cfg.resolved_head_dim, cfg.rope_theta,
                    torch.device("cpu")))
            y, _, _ = block(leaf, mode="train", positions=pos, cache=None,
                            cache_slots=None, rope_tab=tab, memory=memory,
                            mesh=mesh)
        g = torch.from_numpy(dy).to(y.dtype)
        if mesh is not None:
            g = distribute_tensor(g, mesh, y.placements)
        (dx,) = torch.autograd.grad(y, [leaf], g)
        if mesh is not None:
            y, dx = y.full_tensor(), dx.full_tensor()
        return y.detach().float().numpy(), dx.float().numpy()
""")

GLOO = BLOCK_RUN + textwrap.dedent("""
    import json, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    torch.set_num_threads(1)
    rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import DataConfig
    from repro_torch.models import build
    from repro_torch.models.common import placements
    from repro_torch.train import (TrainStepConfig, Trainer, TrainerConfig,
                                   make_train_state_specs, make_train_step,
                                   reshard_state, train_state_from_model)

    with open(f"{tmp}/job.pkl", "rb") as f:
        job = pickle.load(f)
    out = {}
    for arch, (cfg, tree, key, x, mem, dy, batch) in job.items():
        # the block on the mesh, every weight placed by its spec
        model = params_from_numpy(cfg, tree, device="cpu")
        specs = build(cfg).param_specs(mesh)
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            model.get_submodule(owner)._parameters[leaf] = \\
                torch.nn.Parameter(distribute_tensor(
                    p.detach(), mesh, placements(specs[name], mesh)))
        y, dx = run_block(cfg, model, key, x, mem, dy, mesh)
        out[f"{arch}/block"] = {"y": y.tolist(), "dx": dx.tolist()}
        if batch is None:
            continue
        # two sharded train steps
        ts = TrainStepConfig()
        state = reshard_state(train_state_from_model(
            cfg, params_from_numpy(cfg, tree, device="cpu"), ts), mesh,
            make_train_state_specs(cfg, mesh, ts))
        step = make_train_step(cfg, "cpu", ts, mesh=mesh)
        rows = []
        for _ in range(2):
            state, m = step(state, batch)
            rows.append({k: float(v) for k, v in m.items()})
        out[f"{arch}/steps"] = rows
        if arch == job_vision:
            # the same first step without the memory: its cross layers
            # then attend h causally
            state = reshard_state(train_state_from_model(
                cfg, params_from_numpy(cfg, tree, device="cpu"), ts), mesh,
                make_train_state_specs(cfg, mesh, ts))
            _, m = step(state, {"tokens": batch["tokens"]})
            out[f"{arch}/no_memory"] = float(m["loss"])
    # the trainer on the mesh: vision with the launcher's stub image
    # embeddings, two steps
    cfg = job[job_vision][0]
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                      memory_tokens=cfg.vision.n_image_tokens,
                      d_model=cfg.d_model)
    tr = Trainer(cfg, data, TrainerConfig(
        total_steps=2, checkpoint_every=10, checkpoint_dir=sys.argv[4],
        log_every=100), device="cpu", mesh=mesh)
    tr.run()
    out["trainer"] = [[h.step, h.loss] for h in tr.history]
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
""")

# the reference's sharded steps on the same batches, from the same initial
# weights (gates at 1.0), over 4 host devices on an Auto-axis (2, 2) mesh
REF_SHARDED = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.train.train_step import (TrainStepConfig, init_train_state,
                                        make_train_step)

    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))

    def gates_at_one(tree):
        if isinstance(tree, dict):
            return {k: (jnp.ones_like(v) if k == "gate" else
                        gates_at_one(v)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(gates_at_one(v) for v in tree)
        return tree

    out = {}
    for arch, (cfg, batch) in job.items():
        ts = TrainStepConfig()
        b = {"tokens": jnp.asarray(batch["tokens"].astype(np.int32))}
        if "memory" in batch:
            b["memory"] = jnp.asarray(batch["memory"], jnp.bfloat16)
        with mesh:
            step, _ = make_train_step(cfg, mesh, ts, donate=False)
            state = init_train_state(cfg, jax.random.key(0), ts)
            state["params"] = gates_at_one(state["params"])
            rows = []
            for _ in range(2):
                state, m = step(state, b)
                rows.append([float(m["loss"]), float(m["grad_norm"])])
        out[arch] = rows
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 gloo processes' reports (:data:`GLOO`), every rank's, and
    each arch's (cfg, weights, block key, block input, batch)."""
    from repro_torch import configs as tcfgs
    tmp = tmp_path_factory.mktemp("memory_mesh")
    job = {}
    for arch in (*ARCHS, VISION_KV1):
        cfg = _cfg(tcfgs, arch)
        job[arch] = (cfg, _ref_tree(arch), BLOCKS[arch],
                     *_block_input(cfg),
                     _batch(cfg) if arch in ARCHS else None)
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    port = str(_free_port())
    script = f"job_vision = {VISION!r}\n" + GLOO
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), port, str(tmp),
         str(tmp / f"ckpt{r}")], env=_env(OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return {"reps": [_last_json(o) for o, _ in outs], "job": job,
            "tmp": tmp}


def _one_process_block(runs, arch):
    ns: dict = {}
    exec(BLOCK_RUN, ns)
    cfg, tree, key, x, mem, dy, _ = runs["job"][arch]
    model = params_from_numpy(cfg, tree, device="cpu")
    return ns["run_block"](cfg, model, key, x, mem, dy, None)


# (y, dx) limits of a block on the mesh against the one-process block, of
# each one's largest magnitude (see the test's docstring)
BLOCK_LIMITS = (2.0 ** -7, 2.0 ** -6)


@pytest.mark.parametrize("arch", (*ARCHS, VISION_KV1))
def test_block_on_a_mesh_matches_one_process(runs, arch):
    """The first RG-LRU block of reduced recurrentgemma (its width split
    over ``model``), the first cross layer of vision at ten layers (the
    memory batch-sharded, the block sequence parallel; with one kv head
    too, which each device's q heads read, ``kv_heads_read``) and
    seamless's encoder (two layers, non-causal attention), each forward
    and backward on the (2, 2) gloo mesh, the weights placed by their specs,
    against the same block in one process: every rank reports the same
    y and dx; y within one bf16 rounding (2^-7) of its largest magnitude
    (measured: equal, all four), dx within two (2^-6; measured 5.7e-3,
    6.3e-3, 8.8e-3, 6.3e-3).  The mesh's float32 partial sums over ``model``
    round to bf16 once, after their reduction, as one process rounds
    each bf16 product's float32 sum once; the backward's bf16 input
    gradients are summed over ``model`` (and the encoder's two layers)
    in another order."""
    reps = runs["reps"]
    key = f"{arch}/block"
    assert all(r[key] == reps[0][key] for r in reps)
    want_y, want_dx = _one_process_block(runs, arch)
    got_y = np.asarray(reps[0][key]["y"])
    got_dx = np.asarray(reps[0][key]["dx"])
    assert got_y.shape == want_y.shape and got_dx.shape == want_dx.shape
    lim_y, lim_dx = BLOCK_LIMITS
    err_y = np.abs(got_y - want_y).max() / np.abs(want_y).max()
    err_dx = np.abs(got_dx - want_dx).max() / np.abs(want_dx).max()
    print(f"\n{arch} block: y {err_y:.3e}, dx {err_dx:.3e}")
    assert err_y <= lim_y and err_dx <= lim_dx, (err_y, err_dx)


def _one_process_steps(runs, arch):
    cfg, tree, *_, batch = runs["job"][arch]
    state = train_state_from_model(cfg, params_from_numpy(cfg, tree,
                                                          device="cpu"))
    step = make_train_step(cfg, "cpu")
    want = []
    for _ in range(2):
        state, m = step(state, batch)
        want.append({k: float(v) for k, v in m.items()})
    return want


# (first loss, second loss, grad norm) relative limits of the sharded step
# against the one-process step, by arch (see the test's docstring)
STEP_LIMITS = {RGEMMA: (2e-5, 2e-4, 1e-3), SEAMLESS: (2e-5, 2e-4, 1e-3),
               VISION: (1e-4, 1e-3, 3e-3)}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_the_one_process_step(runs, arch):
    """Two sharded train steps of each arch over 4 gloo processes on a
    (2, 2) mesh, from the reference's initial weights (gates at 1.0),
    against the port's one-process step on the same batch (the memory
    too): every rank reports the same numbers.  recurrentgemma and
    seamless under PR 31's limits: the first loss within rel 2e-5
    (measured 7.2e-8, 7.3e-8), the second within 2e-4 (2.3e-5, 1.3e-4:
    AdamW's first update is sign(g) lr, and a gradient entry within
    rounding of zero moves its weight by 2 lr), each gradient norm
    within rel 1e-3 (9.3e-4 and 1.3e-4; 2.1e-6 and 7.8e-4).  vision's
    weights and gradients are bf16 (``bf16_params``): a gradient's
    partial sums over the mesh round to bf16 before they are added, and
    each leaf differs from the one-process one by up to 2e-2 of its
    largest magnitude (float32 leaves, the other two archs, by up to
    1.6e-2), so it is held as PR 32 held deepseek: the first loss within
    1e-4 (1.4e-5: its untied head cut by vocabulary rounds some bf16
    logits otherwise, as h2o's does), the second within 1e-3 (2.5e-4),
    the norms within 3e-3 (5.2e-4, 1.6e-3)."""
    reps = runs["reps"]
    key = f"{arch}/steps"
    assert all(r[key] == reps[0][key] for r in reps)
    want = _one_process_steps(runs, arch)
    got = reps[0][key]
    print(f"\n{arch}: losses {[g['loss'] for g in got]} against "
          f"{[w['loss'] for w in want]}, norms "
          f"{[g['grad_norm'] for g in got]} against "
          f"{[w['grad_norm'] for w in want]}")
    first, second, norm = STEP_LIMITS[arch]
    assert got[0]["loss"] == pytest.approx(want[0]["loss"], rel=first)
    assert got[1]["loss"] == pytest.approx(want[1]["loss"], rel=second)
    for g, w in zip(got, want):
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=norm)
        assert set(g) == set(w)


def test_sharded_step_uses_the_memory(runs):
    """The mesh step carries ``batch["memory"]`` into the forward: vision's
    first sharded step with its memory and the same step without it (the
    cross layers then attend h causally, as the reference's do with no
    memory) differ in loss by more than the bf16 noise of the two
    packages' comparisons (1e-3)."""
    reps = runs["reps"]
    with_mem = reps[0][f"{VISION}/steps"][0]["loss"]
    without = reps[0][f"{VISION}/no_memory"]
    assert all(r[f"{VISION}/no_memory"] == without for r in reps)
    assert abs(with_mem - without) > 1e-3, (with_mem, without)


def test_trainer_on_a_mesh_takes_the_memory(runs):
    """The trainer on the (2, 2) mesh trains vision (ten layers) from its
    data's stub image embeddings (``memory_tokens``), as
    ``launch.train --production-mesh`` does: every rank reports the
    same two steps, whose losses are those of the one-process trainer
    on the same data under vision's limits of the steps (measured 2.1e-5
    at the first step)."""
    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer, TrainerConfig
    reps = runs["reps"]
    got = reps[0]["trainer"]
    assert all(r["trainer"] == got for r in reps)
    cfg = runs["job"][VISION][0]
    one = Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4,
                                  memory_tokens=cfg.vision.n_image_tokens,
                                  d_model=cfg.d_model),
                  TrainerConfig(total_steps=2, checkpoint_every=10,
                                checkpoint_dir=str(runs["tmp"] / "one"),
                                log_every=100), device="cpu")
    one.run()
    assert [s for s, _ in got] == [0, 1]
    first, second, _ = STEP_LIMITS[VISION]
    for (step, loss), h in zip(got, one.history):
        assert loss == pytest.approx(h.loss,
                                     rel=first if step == 0 else second)


@pytest.mark.slow
def test_sharded_steps_match_the_reference_sharded_step(runs, tmp_path):
    """The sharded steps against the reference's (its ``make_train_step``
    on a (2, 2) Auto-axis mesh of 4 host devices, unrolled, from the
    same weights with the gates at 1.0, on the same batch and memory)
    under PR 32's limits: each loss within 1e-2, each gradient norm
    within rel 3e-2 (measured 1.6e-3 and 2.7e-3 at most).  Slow: the
    reference compiles six train steps in a subprocess (about 3 min)."""
    from repro import configs as rcfgs
    job = {arch: (_cfg(rcfgs, arch), runs["job"][arch][-1])
           for arch in ARCHS}
    with open(tmp_path / "ref.pkl", "wb") as f:
        pickle.dump(job, f)
    out = subprocess.run([sys.executable, "-c", REF_SHARDED,
                          str(tmp_path / "ref.pkl")], env=_env(),
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    ref_rows = _last_json(out.stdout)
    reps = runs["reps"]
    for arch in ARCHS:
        for got, (jloss, jnorm) in zip(reps[0][f"{arch}/steps"],
                                       ref_rows[arch]):
            print(f"\n{arch}: loss {got['loss']} / {jloss}, norm "
                  f"{got['grad_norm']} / {jnorm}")
            assert abs(got["loss"] - jloss) < 1e-2, arch
            assert got["grad_norm"] == pytest.approx(jnorm, rel=3e-2), arch
