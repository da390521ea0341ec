"""The MoE mesh dispatch of the port (``repro_torch.models.moe``: the
expert-parallel all-to-all path under both dispatches, the global
scatter path, ``expert_mlp`` under both ``bf16_experts`` settings) and
MLA under a mesh, against the reference on the CPU.

The values of the all-to-all path are held over 4 gloo processes on a
(2, 2) ("data", "model") mesh against the reference's ``apply_moe(impl=
"a2a")`` on an Auto-axis (2, 2) mesh of 4 host devices (its
``make_host_mesh`` gives Explicit axes on jax 0.9.0), from the same
weights and input; the bytes of a production-mesh step are held on a
fake (16, 16) world against the reference's compiled program, which runs
as ``tests/test_torch_dryrun.py`` runs it, in a subprocess (the module
sets 512 host devices on its first line).  Each reference run is a
subprocess started with the gloo processes, so they run together."""

from __future__ import annotations

import dataclasses
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

from repro_torch import perf
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.launch import dryrun
from repro_torch.models import moe as tmoe
from repro_torch.train import make_train_step, train_state_from_model

SRC = Path(__file__).resolve().parents[1] / "src"
SMALL = ShapeConfig("t", 256, 32, "train")
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-v3-671b")
# the all-to-all cases: reduced granite with its experts cut to 7, so that
# they do not divide the model axis (as granite's 40 do not divide 16:
# replicated weights, padded to 8), and reduced deepseek (8 experts over
# the model axis, a shared expert); (4, 16) tokens, 16 a device
A2A_CASES = {"granite-moe-3b-a800m": 7, "deepseek-v3-671b": None}
A2A_SHAPE = (4, 16)
# the input's seed: one whose bf16 router logits hold no top-k near-tie in
# either case (the test checks it) and that drops picks in both dispatches
A2A_SEED = 13


def _ref_reduced(arch):
    from repro.configs import get_arch as ref_get_arch
    return ref_get_arch(arch).reduced()


def _a2a_cfg(arch, ref: bool = False):
    cfg = _ref_reduced(arch) if ref else get_arch(arch).reduced()
    n_e = A2A_CASES[arch]
    return cfg if n_e is None else cfg.replace(
        moe=dataclasses.replace(cfg.moe, n_experts=n_e))


def _step_cfg(arch, capacity_factor):
    cfg = get_arch(arch).reduced()
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


@pytest.fixture(autouse=True)
def _one_thread_no_group():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    assert not dist.is_initialized()
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


def _ref_tree(cfg) -> dict:
    """The reference's initial weights (key 0) as numpy arrays."""
    import jax
    from repro.models import build as jbuild
    from repro.models import unbox
    return jax.tree.map(np.asarray, unbox(jbuild(cfg).init(
        jax.random.key(0))))


def _a2a_input(d_model):
    return np.random.default_rng(A2A_SEED).normal(
        size=(*A2A_SHAPE, d_model)).astype(np.float32)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# The reference's runs (subprocesses)
# ---------------------------------------------------------------------------

REF_A2A = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import perf
    from repro.models.layers import rms_norm
    from repro.models.moe import apply_moe, router_topk

    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    out = {}
    for arch, (cfg, p, x) in cases.items():
        p = jax.tree.map(jnp.asarray, p)
        xj = jnp.asarray(x, jnp.bfloat16)
        for m3 in (True, False):
            perf.set_flags(moe_3d=m3)
            with mesh:
                y, aux = apply_moe(cfg, p, xj, mesh=mesh, impl="a2a")
            out[f"{arch}/{m3}"] = {"y": np.asarray(y, np.float32).tolist(),
                                   "aux": float(aux)}
        # 3 tokens, which do not divide over the 4 devices: the global
        # scatter path
        with mesh:
            y, aux = apply_moe(cfg, p, xj[:1, :3], mesh=mesh, impl="auto")
        out[f"{arch}/scatter"] = {"y": np.asarray(y, np.float32).tolist(),
                                  "aux": float(aux)}
        # each device's picks and kept picks, by the steps of _a2a_body
        b, s, m = x.shape
        moe = cfg.moe
        e_pad = -(-moe.n_experts // 2) * 2
        h = rms_norm(xj, p["norm"], cfg.norm_eps)

        @jax.jit
        def route(blk):
            t = blk.shape[0]
            cap = max(1, int(np.ceil(t * moe.top_k / moe.n_experts
                                     * moe.capacity_factor)))
            logits = blk @ p["router"].astype(blk.dtype)
            _, _, top_idx = router_topk(cfg, logits)
            flat_e = top_idx.reshape(-1)
            onehot = jax.nn.one_hot(flat_e, e_pad, dtype=jnp.int32)
            pos = jnp.cumsum(onehot, axis=0) * onehot - 1
            slot = (pos * onehot).sum(-1)
            return top_idx, slot < cap

        x2d = h.reshape(b * s, m)
        n = b * s // 4
        blocks = {True: [h[d * b // 2:(d + 1) * b // 2,
                           j * s // 2:(j + 1) * s // 2].reshape(-1, m)
                         for d in range(2) for j in range(2)],
                  False: [x2d[i * n:(i + 1) * n] for i in range(4)]}
        for m3, blks in blocks.items():
            rows = []
            for blk in blks:
                idx, keep = route(blk)
                rows.append({"idx": np.asarray(idx).tolist(),
                             "keep": np.asarray(keep).tolist()})
            out[f"{arch}/{m3}/blocks"] = rows
    print(json.dumps(out))
""")

# the reference's compiled dry-run cells of reduced granite and deepseek
# (32 rows of 256 tokens, an Auto-axis (16, 16) mesh), under moe_3d and
# the 2D dispatch
REF_DRYRUN = textwrap.dedent("""
    import json
    from repro.launch import dryrun
    import jax
    import numpy as np
    from repro import perf
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:256]).reshape(16, 16),
                             ("data", "model"))
    shape = ShapeConfig("t", 256, 32, "train")
    out = {}
    for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
        for m3 in (True, False):
            perf.set_flags(moe_3d=m3)
            with mesh:
                m = dryrun._compile_metrics(get_arch(arch).reduced(), shape,
                                            mesh)
            out[f"{arch}/{m3}"] = m["collective_bytes_per_device"]
    print(json.dumps(out))
""")

REF_SHARDED = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_arch
    from repro.train.train_step import (TrainStepConfig, init_train_state,
                                        make_train_step)

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    out = {}
    for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
        for cf in (8.0, 1.25):
            cfg = get_arch(arch).reduced()
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=cf))
            tok = jnp.asarray(np.random.default_rng(1).integers(
                0, cfg.vocab, (4, 32)).astype(np.int32))
            ts = TrainStepConfig()
            with mesh:
                step, _ = make_train_step(cfg, mesh, ts, donate=False)
                state = init_train_state(cfg, jax.random.key(0), ts)
                rows = []
                for _ in range(2):
                    state, m = step(state, {"tokens": tok})
                    rows.append([float(m["loss"]), float(m["grad_norm"])])
            out[f"{arch}/{cf}"] = rows
    print(json.dumps(out))
""")

# ---------------------------------------------------------------------------
# The port's runs over 4 gloo processes
# ---------------------------------------------------------------------------

GLOO = textwrap.dedent("""
    import dataclasses, json, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    torch.set_num_threads(1)
    rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    from repro_torch import perf
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import build
    from repro_torch.models.common import placements
    from repro_torch.train import (TrainStepConfig, make_train_state_specs,
                                   make_train_step, reshard_state,
                                   train_state_from_model)

    with open(f"{tmp}/gloo.pkl", "rb") as f:
        job = pickle.load(f)
    out = {}
    # the all-to-all path: the MoE layer of each case, its weights and
    # input placed on the mesh by their specs (the input in the
    # residual's layout: batch over data, sequence over model)
    for arch, (cfg, tree, x) in job["a2a"].items():
        model = params_from_numpy(cfg, tree, device="cpu")
        first = cfg.moe.first_dense
        moe = model.blocks[first].mlp
        specs = build(cfg).param_specs(mesh)
        for name, p in list(moe.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = moe.get_submodule(owner) if owner else moe
            mod._parameters[leaf] = torch.nn.Parameter(distribute_tensor(
                p.detach(), mesh, placements(
                    specs[f"blocks.{first}.mlp.{name}"], mesh)))
        xt = distribute_tensor(torch.from_numpy(x).bfloat16(), mesh,
                               [Shard(0), Shard(1)])
        for m3 in (True, False):
            perf.set_flags(moe_3d=m3)
            with torch.no_grad():
                y, aux = moe(xt, mesh=mesh)
            out[f"{arch}/{m3}"] = {"y": y.full_tensor().float().tolist(),
                                   "aux": float(aux.full_tensor()),
                                   "placements": str(y.placements)}
        perf.set_flags(moe_3d=True)
        xs = distribute_tensor(torch.from_numpy(x[:1, :3]).bfloat16(), mesh,
                               [Replicate(), Replicate()])
        with torch.no_grad():
            y, aux = moe(xs, mesh=mesh)
        out[f"{arch}/scatter"] = {"y": y.full_tensor().float().tolist(),
                                  "aux": float(aux.full_tensor())}
        # the scatter path's backward (a train step's where the tokens do
        # not divide): 2 x 3 tokens, the rows over data
        xg = distribute_tensor(torch.from_numpy(x[:2, :3]).bfloat16(), mesh,
                               [Shard(0), Replicate()]).requires_grad_()
        y, aux = moe(xg, mesh=mesh)
        names = [n for n, _ in moe.named_parameters()]
        grads = torch.autograd.grad(
            (y.float() ** 2).sum() + 1e3 * aux,
            [xg, *moe.parameters()], allow_unused=True)
        out[f"{arch}/scatter_grads"] = {
            "y": y.full_tensor().float().tolist(),
            "aux": float(aux.full_tensor()),
            "grads": {n: (None if g is None else
                          g.full_tensor().float().tolist())
                      for n, g in zip(["x", *names], grads)}}
    # two sharded train steps of each arch at each capacity factor
    for (arch, cf), (cfg, tree, tok) in job["steps"].items():
        ts = TrainStepConfig()
        state = reshard_state(train_state_from_model(
            cfg, params_from_numpy(cfg, tree, device="cpu"), ts), mesh,
            make_train_state_specs(cfg, mesh, ts))
        step = make_train_step(cfg, "cpu", ts, mesh=mesh)
        rows = []
        for _ in range(2):
            state, m = step(state, {"tokens": tok})
            rows.append({k: float(v) for k, v in m.items()})
        out[f"{arch}/{cf}"] = rows
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
""")


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", **kw)
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_PERF", None)
    return env


def _last_json(text: str):
    return json.loads(text.strip().splitlines()[-1])


STEP_FACTORS = (8.0, 1.25)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the module, started together: the 4 gloo
    processes (:data:`GLOO`), the reference's all-to-all layer
    (:data:`REF_A2A`) and its compiled dry-run cells
    (:data:`REF_DRYRUN`); their reports, the weights and inputs."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    a2a, ref_cases = {}, {}
    for arch in A2A_CASES:
        rcfg = _a2a_cfg(arch, ref=True)
        tree = _ref_tree(rcfg)
        x = _a2a_input(rcfg.d_model)
        a2a[arch] = (_a2a_cfg(arch), tree, x)
        layer = {k: v[0] for k, v in
                 _flat(tree["body"]["pos0"]["mlp"]).items()}
        ref_cases[arch] = (rcfg, _unflat(layer), x)
    trees = {arch: _ref_tree(_ref_reduced(arch)) for arch in MOE_ARCHS}
    steps = {}
    for arch in MOE_ARCHS:
        for cf in STEP_FACTORS:
            cfg = _step_cfg(arch, cf)
            tok = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32))
            steps[(arch, cf)] = (cfg, trees[arch], tok)
    with open(tmp / "gloo.pkl", "wb") as f:
        pickle.dump({"a2a": a2a, "steps": steps}, f)
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(ref_cases, f)
    port = str(_free_port())
    gloo_env = _env(OMP_NUM_THREADS="1")
    procs = {f"gloo{r}": subprocess.Popen(
        [sys.executable, "-c", GLOO, str(r), port, str(tmp)], env=gloo_env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)}
    procs["ref_a2a"] = subprocess.Popen(
        [sys.executable, "-c", REF_A2A, str(tmp / "cases.pkl")], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs["ref_dryrun"] = subprocess.Popen(
        [sys.executable, "-c", REF_DRYRUN], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = {name: p.communicate(timeout=600) for name, p in procs.items()}
    for name, p in procs.items():
        assert p.returncode == 0, (name, outs[name][1][-3000:])
    reps = [_last_json(outs[f"gloo{r}"][0]) for r in range(4)]
    return {"reps": reps, "ref_a2a": _last_json(outs["ref_a2a"][0]),
            "ref_dryrun": _last_json(outs["ref_dryrun"][0]),
            "a2a": a2a, "steps": steps}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


# ---------------------------------------------------------------------------
# One device: expert_mlp, the slot rule, the global scatter path
# ---------------------------------------------------------------------------


def _ref_moe_layer():
    import jax
    from repro.configs import get_arch as ref_get_arch
    from repro.models import unbox
    from repro.models.moe import init_moe
    rcfg = ref_get_arch("granite-moe-3b-a800m").reduced()
    p = jax.tree.map(np.asarray, unbox(init_moe(rcfg, jax.random.key(0))))
    return rcfg, p


@pytest.mark.parametrize("bf16_experts", [False, True])
def test_expert_mlp_matches_reference(bf16_experts):
    """``expert_mlp`` against the reference's ``_expert_mlp_any`` on the
    same bf16 bins and float32 weights: flag off within 1e-5 of the
    largest magnitude (float32 products in another order), on within
    2^-8 (both round ``silu(g) * u`` to bf16 from float32 sums in
    another order, and a rounding that parts moves one bf16 step)."""
    import jax.numpy as jnp
    from repro.models.moe import _expert_mlp_any
    from repro.perf import flags as ref_flags
    from repro.perf import set_flags as ref_set_flags
    _, p = _ref_moe_layer()
    rng = np.random.default_rng(2)
    e, m = p["w_gate"].shape[:2]
    x = rng.normal(size=(e, 12, m)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    old = ref_flags().bf16_experts
    ref_set_flags(bf16_experts=bf16_experts)
    try:
        want = np.asarray(_expert_mlp_any(
            jnp.asarray(x, jnp.bfloat16), *(jnp.asarray(p[k]) for k in
                                            ("w_gate", "w_up", "w_down"))),
            np.float32)
    finally:
        ref_set_flags(bf16_experts=old)
    with _flags(bf16_experts=bf16_experts):
        got = tmoe.expert_mlp(xb, *(torch.tensor(p[k]) for k in
                                    ("w_gate", "w_up", "w_down")))
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= (2.0 ** -8 if bf16_experts else 1e-5), err


@pytest.mark.parametrize("bf16_experts", [False, True])
def test_global_scatter_path_matches_reference(bf16_experts):
    """The port's ``_global_scatter_path`` against the reference's on one
    device, as ``tests/test_perf_flags.py::test_bf16_experts_matches_fp3
    2_path`` draws it (reduced granite, key 0 weights, 64 key-1 normal
    bf16 tokens, capacity 20 for 128 picks over 8 experts, so picks are
    dropped): y within 2^-7 of its largest magnitude (the port sums the
    k picks in float32, the reference adds bf16 rows), the aux loss
    within rel 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import _global_scatter_path
    from repro.perf import flags as ref_flags
    from repro.perf import set_flags as ref_set_flags
    rcfg, p = _ref_moe_layer()
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    xj = jax.random.normal(jax.random.key(1), (64, rcfg.d_model),
                           jnp.bfloat16)
    old = ref_flags().bf16_experts
    ref_set_flags(bf16_experts=bf16_experts)
    try:
        want, aux_w = _global_scatter_path(
            rcfg, jax.tree.map(jnp.asarray, p), xj)
    finally:
        ref_set_flags(bf16_experts=old)
    want = np.asarray(want, np.float32)
    x = torch.from_numpy(np.asarray(xj, np.float32)).bfloat16()
    tp = {k: torch.tensor(v) for k, v in p.items()
          if not isinstance(v, dict)}
    with _flags(bf16_experts=bf16_experts):
        got, aux = tmoe._global_scatter_path(cfg, tp, x)
    logits = x @ tp["router"].bfloat16()
    _, _, idx = tmoe.router_topk(cfg, logits)
    cap = tmoe.capacity(64, cfg.moe)
    _, keep = tmoe.slot_rule(idx, cfg.moe.n_experts, cap)
    assert cap == 20 and not bool(keep.all())
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2.0 ** -7, err
    assert float(aux) == pytest.approx(float(aux_w), rel=1e-5)


def _flags(**kw):
    import contextlib

    @contextlib.contextmanager
    def ctx():
        old = {k: getattr(perf.flags(), k) for k in kw}
        perf.set_flags(**kw)
        try:
            yield
        finally:
            perf.set_flags(**old)
    return ctx()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_rule_is_the_reference_count(seed):
    """``slot_rule``'s rank among the expert's picks by a stable sort
    equals the reference's running count over the one-hot
    (``cumsum(onehot) * onehot - 1``), and the kept picks those below
    the capacity."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    t, k, e, cap = 97, 3, 11, 20
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    onehot = jax.nn.one_hot(jnp.asarray(idx.reshape(-1)), e,
                            dtype=jnp.int32)
    want = np.asarray(((jnp.cumsum(onehot, axis=0) * onehot - 1)
                       * onehot).sum(-1))
    slot, keep = tmoe.slot_rule(torch.from_numpy(idx), e, cap)
    np.testing.assert_array_equal(slot.numpy(), want)
    np.testing.assert_array_equal(keep.numpy(), want < cap)
    assert not bool(keep.all())


def test_dispatch_keeps_the_kept_pick_at_slot_zero():
    """A dropped pick must not overwrite its expert's slot 0 (the
    reference adds a zero row there; a write with no accumulation would
    replace the kept row): token 0 takes expert 1's slot 0, tokens 1-2
    overflow its capacity of 1 and are dropped; the bins hold token 0's
    row at (1, 0), the dropped picks' rows nowhere, and the combine
    gives them nothing."""
    x = torch.arange(3 * 4, dtype=torch.float32).view(3, 4) + 1.0
    idx = torch.tensor([[1], [1], [1]])
    slot, keep = tmoe.slot_rule(idx, 2, 1)
    assert slot.tolist() == [0, 1, 2] and keep.tolist() == [True, False,
                                                             False]
    bins, index = tmoe.dispatch(x, idx, slot, keep, 2, 1)
    assert torch.equal(bins[1, 0], x[0]) and not bool(bins[0].any())
    assert index.tolist() == [1, 2, 2]
    out = tmoe.combine(bins, index, torch.ones((3, 1)), keep)
    assert torch.equal(out[0], x[0]) and not bool(out[1:].any())


def test_expert_mlp_refuses_tf32():
    """With the flag off the expert products are float32: a setting
    that lets TF32 in raises."""
    x = torch.zeros((2, 3, 4))
    w = torch.zeros((2, 4, 5)), torch.zeros((2, 4, 5)), \
        torch.zeros((2, 5, 4))
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            tmoe.expert_mlp(x, *w)
    finally:
        torch.set_float32_matmul_precision(old)
    assert tmoe.expert_mlp(x, *w).shape == (2, 3, 4)


# ---------------------------------------------------------------------------
# The all-to-all path over 4 gloo processes
# ---------------------------------------------------------------------------


def _a2a_layer(runs, arch):
    """(port cfg, the port's MoE layer on one device, bf16 input)."""
    cfg, tree, x = runs["a2a"][arch]
    model = params_from_numpy(cfg, tree, device="cpu")
    return cfg, model.blocks[cfg.moe.first_dense].mlp, \
        torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("moe_3d", [True, False])
@pytest.mark.parametrize("arch", list(A2A_CASES))
def test_a2a_path_matches_reference(runs, arch, moe_3d):
    """The all-to-all path on a (2, 2) gloo mesh against the reference's
    ``apply_moe(impl="a2a")`` on an Auto-axis (2, 2) host mesh, at the
    default capacity factor: C = 6 (granite, 7 experts padded to 8) or 5
    (deepseek) rows a bin for 16 tokens a device.  Every rank reports
    the same y.  The picks and the kept picks of every device equal the
    reference's, and at least one pick is dropped.  The drawn logits
    hold no top-k near-tie: every gap between the k + 1 largest bf16
    logits of a token exceeds two bf16 steps at their magnitude, so a
    rounding that parts between the two packages (one step) cannot
    change a pick.  y within 2^-7 of its largest magnitude (the port
    sums the k picks in float32, the reference adds bf16 rows), aux
    within rel 1e-5."""
    reps, ref = runs["reps"], runs["ref_a2a"]
    key = f"{arch}/{moe_3d}"
    assert all(r[key] == reps[0][key] for r in reps)
    cfg, layer, x = _a2a_layer(runs, arch)
    from repro_torch.models.layers import rms_norm
    with torch.no_grad():
        h = rms_norm(x, layer.norm, cfg.norm_eps)
        b, s, m = h.shape
        if moe_3d:
            blocks = [h[d * b // 2:(d + 1) * b // 2,
                        j * s // 2:(j + 1) * s // 2].reshape(-1, m)
                      for d in range(2) for j in range(2)]
        else:
            flat = h.reshape(b * s, m)
            n = b * s // 4
            blocks = [flat[i * n:(i + 1) * n] for i in range(4)]
        e_pad = tmoe.expert_pad(cfg.moe.n_experts, 2)
        dropped = 0
        for blk, want in zip(blocks, ref[f"{key}/blocks"]):
            cap = tmoe.capacity(blk.shape[0], cfg.moe)
            logits = blk @ layer.router.to(blk.dtype)
            _, _, idx = tmoe.router_topk(cfg, logits)
            _, keep = tmoe.slot_rule(idx, e_pad, cap)
            top = torch.sort(logits.float(), dim=-1, descending=True)\
                .values[:, :cfg.moe.top_k + 1].double()
            step = 2.0 ** (torch.floor(torch.log2(top.abs())) - 7)
            assert bool((top[:, :-1] - top[:, 1:] > 2 * step[:, :-1]).all())
            assert idx.tolist() == want["idx"]
            assert keep.tolist() == want["keep"]
            dropped += int((~keep).sum())
        assert dropped > 0
    got = np.asarray(reps[0][key]["y"])
    want = np.asarray(ref[key]["y"])
    assert got.shape == want.shape == tuple(x.shape)
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    assert reps[0][key]["aux"] == pytest.approx(ref[key]["aux"], rel=1e-5)


@pytest.mark.parametrize("arch", list(A2A_CASES))
def test_scatter_path_on_a_mesh_matches_reference(runs, arch):
    """3 tokens on the (2, 2) mesh, which do not divide over its 4
    devices: the global scatter path on the replicated tokens and
    weights (C = 2) against the reference's
    ``apply_moe`` there (its ``_global_scatter_path``, placed by GSPMD):
    y within 2^-7 of its largest magnitude, aux within rel 1e-5."""
    reps, ref = runs["reps"], runs["ref_a2a"]
    key = f"{arch}/scatter"
    assert all(r[key] == reps[0][key] for r in reps)
    got, want = np.asarray(reps[0][key]["y"]), np.asarray(ref[key]["y"])
    assert got.shape == want.shape == (1, 3, runs["a2a"][arch][0].d_model)
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    assert reps[0][key]["aux"] == pytest.approx(ref[key]["aux"], rel=1e-5)


@pytest.mark.parametrize("arch", list(A2A_CASES))
def test_scatter_path_gradients_on_a_mesh(runs, arch):
    """The global scatter path's backward on the (2, 2) mesh (2 x 3
    tokens, the rows over "data": a train step's path where the tokens
    do not divide over the devices) against the port's one-device
    ``_global_scatter_path`` on the same weights and tokens (the shared
    expert added, the aux weighted, the loss sum y^2 + 1000 aux): the
    output within 2^-7 of its largest magnitude, the aux within rel
    1e-5, the gradients of x and of every weight within 2^-6 of each
    leaf's largest magnitude (measured: the experts' equal, the rest
    within 6.9e-3; x's bf16 gradient sums its picks' and the router's
    terms in another order, over ``model`` where the experts are split
    there, which a gradient placed as x's would miss)."""
    from repro_torch.models.layers import rms_norm
    reps = runs["reps"]
    key = f"{arch}/scatter_grads"
    assert all(r[key] == reps[0][key] for r in reps)
    cfg, tree, x = runs["a2a"][arch]
    layer = params_from_numpy(cfg, tree, device="cpu").blocks[
        cfg.moe.first_dense].mlp
    xg = torch.from_numpy(x[:2, :3]).bfloat16().requires_grad_()
    h = rms_norm(xg, layer.norm, cfg.norm_eps)
    p = {n: getattr(layer, n) for n in ("router", "w_gate", "w_up",
                                         "w_down")}
    y2d, aux = tmoe._global_scatter_path(cfg, p, h.reshape(-1, h.shape[-1]))
    y = y2d.view(h.shape)
    if layer.shared is not None:
        y = y + layer.shared(h, skip_norm=True)
    aux = aux * cfg.moe.router_aux_weight
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((y.float() ** 2).sum() + 1e3 * aux,
                                [xg, *layer.parameters()], allow_unused=True)
    got = reps[0][key]
    want_y = y.detach().float().numpy()
    assert np.abs(np.asarray(got["y"]) - want_y).max() <= \
        2.0 ** -7 * np.abs(want_y).max()
    assert got["aux"] == pytest.approx(float(aux.detach()), rel=1e-5)
    worst = {}
    for name, g in zip(["x", *names], grads):
        mine = got["grads"][name]
        assert (mine is None) == (g is None), name
        if g is None:
            continue
        want = g.detach().float().numpy()
        err = np.abs(np.asarray(mine) - want).max() / max(
            np.abs(want).max(), 1e-30)
        assert err <= 2.0 ** -6, (name, err)
        worst[name] = err
    print(f"\n{arch} scatter path gradients, error over each leaf's "
          f"largest magnitude: " + ", ".join(f"{k} {v:.2e}"
                                             for k, v in worst.items()))


def _float32_route(monkeypatch):
    """The one-process step's MoE layers through the mesh path's
    float32 experts: the scatter path's steps at a capacity of T rows
    (no pick dropped), in place of the one-card route's experts in the
    activation dtype (the reference's one-device ``_dense_path`` runs in
    bf16 too)."""
    def route(self, x2d, top_w, top_idx):
        t = x2d.shape[0]
        e = self.cfg.moe.n_experts
        slot, keep = tmoe.slot_rule(top_idx, e, t)
        bins, index = tmoe.dispatch(x2d, top_idx, slot, keep, e, t)
        y = tmoe.expert_mlp(bins, self.w_gate, self.w_up, self.w_down)
        return tmoe.combine(y.to(x2d.dtype), index, top_w, keep)
    monkeypatch.setattr(tmoe.MoE, "route", route)


# (first loss, second loss, grad norm) relative limits of the sharded step
# against the one-process step, by arch (see the test's docstring)
STEP_LIMITS = {"granite-moe-3b-a800m": (2e-5, 2e-4, 3e-3),
               "deepseek-v3-671b": (1e-4, 1e-3, 3e-3)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_moe_steps_match_the_one_process_step(runs, arch,
                                                      monkeypatch):
    """Two sharded train steps of reduced granite and reduced deepseek
    (MoE and, for deepseek, MLA with its heads split, the MTP head,
    sequence parallelism) over 4 gloo processes on a (2, 2) mesh, from
    the reference's initial weights, at ``capacity_factor=8.0`` (no pick
    dropped: the one-process route never drops, so at the default factor
    the two differ by design), against the port's one-process step on
    the same batch with its experts in float32 as the mesh path computes
    them (:func:`_float32_route`).  Every rank reports the same numbers.
    granite: the first loss within rel 2e-5 (measured 7e-8), the second
    within 2e-4 (1.0e-4), each gradient norm within rel 3e-3 (1.3e-4,
    1.6e-3): AdamW's first update is sign(g) lr, so an entry within
    rounding of zero moves its weight by 2 lr, and the router's top-k
    passes that on.  deepseek: the first loss within rel 1e-4 (measured
    4.6e-5), the second within 1e-3 (2.4e-4), the norms within 3e-3
    (1.9e-4, 5.9e-4): MLA's output product cut over the model axis sums
    its float32 partial sums in another order, one bf16 entry in some
    16,000 of the first block's output rounds one step otherwise, and
    the router's picks carry such a step on to whole expert outputs."""
    _float32_route(monkeypatch)
    reps = runs["reps"]
    key = f"{arch}/8.0"
    assert all(r[key] == reps[0][key] for r in reps)
    cfg, tree, tok = runs["steps"][(arch, 8.0)]
    state = train_state_from_model(cfg, params_from_numpy(cfg, tree,
                                                          device="cpu"))
    step = make_train_step(cfg, "cpu")
    want = []
    for _ in range(2):
        state, m = step(state, {"tokens": tok})
        want.append({k: float(v) for k, v in m.items()})
    first, second, norm = STEP_LIMITS[arch]
    got = reps[0][key]
    assert got[0]["loss"] == pytest.approx(want[0]["loss"], rel=first)
    assert got[1]["loss"] == pytest.approx(want[1]["loss"], rel=second)
    for g, w in zip(got, want):
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=norm)
        assert set(g) == set(w)


@pytest.mark.slow
def test_sharded_moe_steps_match_the_reference_sharded_step(runs):
    """The sharded steps at the default capacity factor and at 8.0
    against the reference's (its ``make_train_step`` on a (2, 2)
    Auto-axis mesh of 4 host devices, from the same weights on the same
    batch): each loss within 1e-2, each gradient norm within rel 3e-2.
    ``test_torch_dryrun.py`` holds the dense cells' losses to 1e-3; the
    reference's compiled step rounds the router's bf16 logits otherwise
    than its eager ops (XLA fuses the norm into the router's product,
    ``test_torch_archs.py``), which moves picks at near-ties and with
    them which picks drop: measured 2.1e-3 (granite) and 6.9e-4
    (deepseek) at 8.0, 4.5e-3 and 3.5e-3 at the default factor, where
    the port's layer alone matches the eager reference's picks exactly
    (:func:`test_a2a_path_matches_reference`).  Slow: the reference
    compiles four train steps in a subprocess."""
    out = subprocess.run([sys.executable, "-c", REF_SHARDED], env=_env(),
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    ref_rows = _last_json(out.stdout)
    reps = runs["reps"]
    for arch in MOE_ARCHS:
        for cf in STEP_FACTORS:
            key = f"{arch}/{cf}"
            for got, (jloss, jnorm) in zip(reps[0][key], ref_rows[key]):
                assert abs(got["loss"] - jloss) < 1e-2, key
                assert got["grad_norm"] == pytest.approx(jnorm,
                                                          rel=3e-2), key


# ---------------------------------------------------------------------------
# The production-mesh dry run (fake (16, 16) world)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def records():
    out = {}
    for arch in MOE_ARCHS:
        for m3 in (True, False):
            with _flags(moe_3d=m3):
                out[f"{arch}/{m3}"] = dryrun.lower_cell(
                    arch, "t", False, "cpu", cfg=get_arch(arch).reduced(),
                    shape=SMALL)
    return out


# the bins of reduced granite and deepseek on (16, 16): 2 MoE layers x 6
# all-to-alls (forward, remat recompute, backward; each both ways) of
# (16, 10, 128) bf16 (8 experts padded to 16, C = ceil(32 x 2 / 8 x 1.25))
REDUCED_BINS = 2 * 6 * 16 * 10 * 128 * 2


@pytest.mark.parametrize("moe_3d", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dryrun_all_to_all_bytes_equal_reference(records, runs, arch,
                                                 moe_3d):
    """The reduced cells (32 x 256 on a fake (16, 16) world): the port's
    all-to-all bytes are the bins' alone, 491,520 B, all over ``model``
    in the loss phase, under both dispatches; under ``moe_3d`` they
    equal the reference's compiled program's.  The 2D dispatch's
    reference program adds GSPMD's re-layout all-to-alls (574,208 and
    604,928 B), which the port makes as all-gathers.  Every other kind
    is logged as a port / reference ratio (under ``-s``), as
    ``test_torch_dryrun.py`` does for the dense cells."""
    rec = records[f"{arch}/{moe_3d}"]
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    got = rec["collective_bytes_per_device"]
    want = runs["ref_dryrun"][f"{arch}/{moe_3d}"]
    assert got["all-to-all"] == REDUCED_BINS
    assert {k: v.get("all-to-all") for k, v in
            rec["collective_bytes_by_phase_axis"].items()
            if v.get("all-to-all")} == {"loss/model": REDUCED_BINS}
    if moe_3d:
        assert want["all-to-all"] == REDUCED_BINS
    else:
        assert want["all-to-all"] > REDUCED_BINS
    print(f"\n{arch} moe_3d={moe_3d}: " + ", ".join(
        f"{k} {got.get(k, 0):,} / {want.get(k, 0):,} B" + (
            f" ({got[k] / want[k]:.4f})" if got.get(k) and want.get(k)
            else "") for k in sorted(set(got) | set(want))))
    coll = rec["collective_bytes_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dryrun_data_parallel_bytes_and_kernel_problems(records, arch):
    """The data-parallel gradient all-reduce of the reduced cells is the
    gradients (in the parameters' dtype) of the local blocks not sharded
    over ``data``, but the shared-expert norm, which the loss never
    reads; deepseek books its MLA calls (forward and remat recompute of
    3 blocks, the MTP block once) under ``"mla"`` at q/k 32 and v 16."""
    from repro_torch.models import build
    from repro_torch.models.common import local_shape
    from repro_torch.models.model import param_shapes
    cfg = get_arch(arch).reduced()
    mesh = {"data": 16, "model": 16}
    specs = build(cfg).param_specs(mesh)
    want = 0
    for name, (shape, dt) in param_shapes(cfg).items():
        flat = [a for e in specs[name] if e
                for a in ((e,) if isinstance(e, str) else e)]
        if "data" not in flat and not name.endswith("mlp.shared.norm"):
            want += int(np.prod(local_shape(shape, specs[name], mesh))) \
                * torch.empty((), dtype=dt).element_size()
    for m3 in (True, False):
        rec = records[f"{arch}/{m3}"]
        assert rec["dp_gradient_bytes"] == {"all-reduce": want}
    problems = records[f"{arch}/True"]["kernel_problems"]
    if arch.startswith("deepseek"):
        assert problems == {"mla": [[2, 4, 256, 256, 32, 16, 7]]}
    else:
        assert problems == {"attention": [[2, 4, 2, 256, 256, 32, None, True,
                                           4]]}


def test_kernel_flops_count_mla_at_its_own_heads():
    """An MLA problem's products at q/k 192 (Q K^T, dS K, dS^T Q) and v
    128 (P.V, dO V^T, P^T dO); the padding to the kernels' 256 apart."""
    b, h, s = 16, 8, 4096
    pairs = 2.0 * h * b * (s * (s + 1) // 2)
    launches = {"flash_attention_fwd": 10, "flash_attention_dq": 5,
                "flash_attention_dkv": 5}
    problems = {"mla": {(b, h, s, s, 192, 128): 10}}
    want = pairs * (10 * (192 + 128) + 5 * (2 * 192 + 128)
                    + 5 * (2 * 192 + 2 * 128))
    assert dryrun.kernel_flops(problems, launches) == pytest.approx(want)
    padded = pairs * 256 * (10 * 2 + 5 * 3 + 5 * 4)
    assert dryrun.kernel_padding_flops(problems, launches) \
        == pytest.approx(padded - want)
    both = dict(problems, attention={(b, h, h, s, s, 64, None, True): 1})
    with pytest.raises(ValueError, match="share"):
        dryrun.kernel_flops(both, launches)


# ---------------------------------------------------------------------------
# The other block kinds on a mesh; what raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kind", [
    ("recurrentgemma-9b", "rglru"),
    ("llama-3.2-vision-90b", "xattn"),
    ("seamless-m4t-large-v2", "dec_xattn")])
def test_rglru_and_memory_blocks_run_on_a_mesh(arch, kind):
    """The RG-LRU and the memory-input blocks run on a mesh (their values
    are held over gloo in ``tests/test_torch_memory_mesh.py``): on a fake
    (2, 2) world each reduced block, its weights placed by their specs,
    takes h (2, 8, M) and a memory (2, 4, M) over ``data`` and returns h
    in the layout of its kind (batch over ``data``; the sequence over
    ``model`` for vision's sequence-parallel cross layer), and its
    backward reaches every weight."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.common import placements
    from repro_torch.models.layers import replicated, rope_table
    from repro_torch.models.model import build
    from repro_torch.models.transformer import Block, layer_plan
    cfg = get_arch(arch).reduced()
    if kind == "xattn":
        cfg = cfg.replace(n_layers=10)     # reduced() keeps no cross layer
    block = Block(cfg, kind, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        specs = build(cfg).param_specs(mesh)
        idx = layer_plan(cfg).kinds.index(kind)
        for name, p in list(block.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            block.get_submodule(owner)._parameters[leaf] = \
                torch.nn.Parameter(distribute_tensor(
                    p.detach(), mesh,
                    placements(specs[f"blocks.{idx}.{name}"], mesh)))
        h = distribute_tensor(torch.zeros((2, 8, cfg.d_model)), mesh,
                              [Shard(0), Replicate()]).bfloat16()
        mem = distribute_tensor(torch.zeros((2, 4, cfg.d_model)), mesh,
                                [Shard(0), Replicate()]).bfloat16()
        h.requires_grad_(True)
        pos = torch.arange(8)
        tab = tuple(replicated(t, mesh) for t in rope_table(
            pos, cfg.resolved_head_dim, cfg.rope_theta, pos.device))
        out, cache, _ = block(h, mode="train", positions=pos, cache=None,
                              cache_slots=None, rope_tab=tab, memory=mem,
                              mesh=mesh)
        grads = torch.autograd.grad(out.float().sum(), [
            h, *block.parameters()], allow_unused=True)
    seq = Shard(1) if cfg.seq_shard and kind != "rglru" else Replicate()
    assert tuple(out.shape) == (2, 8, cfg.d_model) and cache == {
        "mixer": None, **({"cross": None} if kind == "dec_xattn" else {})}
    assert tuple(out.placements) == (Shard(0), seq)
    assert all(g is not None for g in grads)


def test_moe_on_a_one_device_mesh_raises():
    """A one-device mesh runs the one-card route on the local tensors,
    as the reference's ``apply_moe`` takes its meshless route on one
    device: the layer's output, aux and every gradient (reduced
    deepseek's, with its shared expert, the weights placed on a (1, 1)
    mesh) bit for bit those without a mesh, with and without the aux."""
    from repro_torch.launch.mesh import make_host_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    cfg = get_arch("deepseek-v3-671b").reduced()
    mesh = make_host_mesh(1, 1, device_type="cpu")
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).bfloat16()

    def layer():
        return tmoe.MoE(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))

    plain, placed = layer(), layer()
    for name, p in list(placed.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = placed.get_submodule(owner) if owner else placed
        mod._parameters[leaf] = torch.nn.Parameter(distribute_tensor(
            p.detach(), mesh, [Replicate(), Replicate()]))
    for with_aux in (True, False):
        xa = x.clone().requires_grad_()
        xb = distribute_tensor(x.clone(), mesh, [Replicate(), Replicate()])
        xb.requires_grad_()
        ya, aux_a = plain(xa, with_aux=with_aux)
        yb, aux_b = placed(xb, with_aux=with_aux, mesh=mesh)
        assert torch.equal(yb.full_tensor(), ya)
        if not with_aux:
            assert aux_a is None and aux_b is None
            continue
        assert torch.equal(aux_b.full_tensor(), aux_a)
        loss_a = ya.float().square().sum() + aux_a
        loss_b = yb.float().square().sum() + aux_b
        ga = torch.autograd.grad(loss_a, [xa, *plain.parameters()],
                                 allow_unused=True)
        gb = torch.autograd.grad(loss_b, [xb, *placed.parameters()],
                                 allow_unused=True)
        for a, b in zip(ga, gb):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(b.full_tensor(), a)
