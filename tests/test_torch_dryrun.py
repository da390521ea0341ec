"""The port's production-mesh dry run (``repro_torch.launch.dryrun``) and
sharded train step against the reference on the CPU.

A fake process group stands for the other ranks (collectives return at
once and carry nothing), so these tests read shapes and bytes, never
values; the values of a sharded step are held over 4 gloo processes
instead.  The reference's own dry run is run as its lower_cell would
run it but on an Auto-axis mesh: its ``make_production_mesh`` gives
Explicit axes on jax 0.9.0, which its sharding constraints reject
(ROADMAP queue 3); it imports in a subprocess, since the module sets
512 host devices on its first line."""

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

import repro.fabric as RF
from repro.perf import flags as ref_flags
from repro.perf import set_flags as ref_set_flags
from repro_torch import perf
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.fabric import StepProfile, plan
from repro_torch.launch import dryrun
from repro_torch.train import (TrainStepConfig, init_train_state,
                               make_train_step)

SRC = Path(__file__).resolve().parents[1] / "src"
# the reference's dry-run cell of these tests: 32 rows of 256 tokens
SMALL = ShapeConfig("t", 256, 32, "train")
# the float32 gradients of the 115,328 local parameters of reduced
# smollm that are not sharded over "data" on the (16, 16) mesh
SMOLLM_DP_BYTES = 461_312


@pytest.fixture(autouse=True)
def _one_thread_no_group():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    assert not dist.is_initialized()
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


def _cell(arch: str, **flag_kw) -> dict:
    old = {k: getattr(perf.flags(), k) for k in flag_kw}
    perf.set_flags(**flag_kw)
    try:
        return dryrun.lower_cell(arch, "t", False, "cpu",
                                 cfg=get_arch(arch).reduced(), shape=SMALL)
    finally:
        perf.set_flags(**old)


@pytest.fixture(scope="module")
def records():
    return {arch: _cell(arch) for arch in ("smollm-135m", "mamba2-130m")}


REF_DRYRUN = textwrap.dedent(r"""
    import json, re
    from repro.launch import dryrun
    import jax
    import numpy as np
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:256]).reshape(16, 16),
                             ("data", "model"))
    shape = ShapeConfig("t", 256, 32, "train")
    ids = np.arange(256).reshape(16, 16)
    axes = {tuple(ids[0]): "model", tuple(ids[:, 0]): "data"}

    def first_group(line):
        # iota form [G,S]<=[dims]T(perm), or an explicit list {{...},...}
        m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
                      r"(?:T\(([\d,]+)\))?", line)
        if m:
            g = np.arange(256).reshape([int(d) for d in m[3].split(",")])
            if m[4]:
                g = g.transpose([int(d) for d in m[4].split(",")])
            return tuple(g.reshape(int(m[1]), int(m[2]))[0])
        m = re.search(r"replica_groups=\{\{([\d,]+)\}", line)
        return tuple(int(d) for d in m[1].split(",")) if m else ()

    out = {}
    for arch in ("smollm-135m", "mamba2-130m"):
        with mesh:
            m = dryrun._compile_metrics(get_arch(arch).reduced(), shape,
                                        mesh)
        out[arch] = m["collective_bytes_per_device"]
    # smollm with its layers unrolled: each layer's collectives in the
    # program once, as the port runs them (the scanned program holds the
    # layer body once, and collective_bytes reads it once)
    cfg = get_arch("smollm-135m").reduced().replace(scan_layers=False)
    with mesh:
        text = dryrun._lower_any(cfg, shape, mesh).compile().as_text()
    rows = []
    for line in text.splitlines():
        m = dryrun.COLLECTIVE_RE.search(line)
        if m:
            rows.append([m[2], axes.get(first_group(line), "other"),
                         dryrun.SHAPE_RE.findall(m[1]),
                         dryrun._shape_bytes(m[1])])
    out["smollm-135m unrolled"] = {
        "bytes": dryrun.collective_bytes(text), "rows": rows}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_bytes():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_PERF", None)
    out = subprocess.run([sys.executable, "-c", REF_DRYRUN], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_data_parallel_gradient_bytes_exact(records):
    """(i) reduced smollm on a fake (16, 16) world: the gradient phase's
    all-reduce over "data" is the float32 gradients of exactly the local
    parameters, no more."""
    rec = records["smollm-135m"]
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["dp_gradient_bytes"] == {"all-reduce": SMOLLM_DP_BYTES}
    assert rec["per_device_batch"] == [2, 256]
    coll = rec["collective_bytes_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert sum(r["bytes"] * r["count"] for r in rec["collectives"]) \
        == coll["total"]
    assert rec["flops"] > 0 and rec["memory"]["argument_bytes"] > 0
    for key in ("compile_seconds", "hlo_chars", "probe", "raw",
                "bytes_accessed", "transcendentals"):
        assert rec[key] is None


def test_smollm_collectives_against_reference(records, ref_bytes):
    """(ii) the same cell against the reference's compiled program: the
    same kinds (all-reduce only: the data-parallel gradients, the
    tensor-parallel MLP and vocab reductions, in float32 as its HLO has
    them), the total within 2x.  The port's total is 1.30x that count,
    which reads the scanned layer stack's body once for its 2 layers.
    Against the same config unrolled, every layer's collectives once as
    the port runs them, the port moves fewer bytes, collective by
    collective (printed under ``-s``): its float32 (rows, S, M)
    activation all-reduces over "model" are the embedding lookup's, each
    layer's MLP output's, the head's input gradient's and each layer's
    MLP input gradient's (2 + 2L), where the reference reduces the gate
    and up projections' input gradients separately (2 + 3L); no other
    port collective carries more than the reference's rest."""
    rec = records["smollm-135m"]
    got = rec["collective_bytes_per_device"]
    want = ref_bytes["smollm-135m"]
    assert set(got) == set(want) == {"all-reduce", "total"}
    assert 0.5 <= got["total"] / want["total"] <= 2.0
    unrolled = ref_bytes["smollm-135m unrolled"]
    layers = get_arch("smollm-135m").reduced().n_layers
    act = ["f32", f"{rec['per_device_batch'][0]},256,128"]
    act_bytes = 4 * rec["per_device_batch"][0] * 256 * 128
    ref_act = sum(shapes.count(act) for kind, axis, shapes, _ in
                  unrolled["rows"] if axis == "model")
    port_act = sum(r["count"] for r in rec["collectives"]
                   if r["at"] == "loss/model" and r["shape"]
                   == f"{act[0]}[{act[1]}]")
    print(f"\nport {got['total']:,} B; reference scanned "
          f"{want['total']:,} B ({got['total'] / want['total']:.4f}), "
          f"unrolled {unrolled['bytes']['total']:,} B "
          f"({got['total'] / unrolled['bytes']['total']:.4f}); activation "
          f"all-reduces over model: port {port_act}, reference {ref_act}")
    for r in rec["collectives"]:
        print(f"  port  {r['at']:18s} {r['kind']:10s} {r['shape']:24s} "
              f"{r['bytes']:>8,} B x {r['count']}")
    for kind, axis, shapes, nbytes in unrolled["rows"]:
        print(f"  ref   {axis:18s} {kind:10s} {len(shapes):3d} operands "
              f"{nbytes:>8,} B: {shapes[:4]}")
    assert (port_act, ref_act) == (2 + 2 * layers, 2 + 3 * layers)
    assert got["total"] - port_act * act_bytes \
        <= unrolled["bytes"]["total"] - ref_act * act_bytes
    assert got["total"] < unrolled["bytes"]["total"]


def test_mamba2_collectives_against_reference(records, ref_bytes):
    """(iii) reduced mamba2 likewise: the total within 2x.  Both reduce
    gradients and activations by all-reduce and gather by all-gather;
    GSPMD also shifts the depthwise conv's halo by collective-permute and
    re-lays activations by all-to-all, where the port gathers the in_proj
    and conv weights and its backward reduce-scatters the split
    activations' gradients (PERF.md §6)."""
    rec = records["mamba2-130m"]
    got, want = rec["collective_bytes_per_device"], ref_bytes["mamba2-130m"]
    assert {"all-reduce", "all-gather"} <= set(got) & set(want)
    assert set(got) <= {"all-reduce", "all-gather", "reduce-scatter",
                        "total"}
    assert 0.5 <= got["total"] / want["total"] <= 2.0
    assert rec["dp_gradient_bytes"] == {"all-reduce": 71_376}


@pytest.fixture
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(1, 1, device_type="cpu")


def test_zero1_on_one_device_is_the_plain_step(host_mesh):
    """(iv) zero1 on a (1, 1) mesh: the plain step, bit for bit."""
    cfg = get_arch("smollm-135m").reduced()
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    states, losses = [], []
    for ts, mesh in ((TrainStepConfig(), None),
                     (TrainStepConfig(zero1=True), host_mesh)):
        state = init_train_state(cfg, 0, ts, device="cpu")
        step = make_train_step(cfg, "cpu", ts, mesh=mesh)
        for _ in range(2):
            state, m = step(state, {"tokens": tok})
            losses.append(float(m["loss"]))
        states.append(state)
    assert losses[:2] == losses[2:]
    for name, p in states[0]["params"].items():
        assert torch.equal(p, states[1]["params"][name]), name
        assert torch.equal(states[0]["opt"]["v"][name],
                           states[1]["opt"]["v"][name]), name


def _small_mesh_cell(zero1: bool) -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    old = perf.flags().zero1
    perf.set_flags(zero1=zero1)
    try:
        with dryrun.fake_world(8):
            mesh = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
            return dryrun._step_metrics(get_arch("smollm-135m").reduced(),
                                        SMALL, mesh, torch.device("cpu"))
    finally:
        perf.set_flags(zero1=old)


def test_zero1_reduce_scatters_the_replicated_gradients():
    """(v) zero1 on a fake (2, 4) world: the replicated gradients' data
    all-reduce becomes a reduce-scatter over "data" (1/2 of their bytes
    a device) and the parameters come back by an all-gather of their
    whole bytes; nothing else over "data" changes."""
    plain, z = _small_mesh_cell(False), _small_mesh_cell(True)
    pa = plain["collective_bytes_by_phase_axis"]
    za = z["collective_bytes_by_phase_axis"]
    assert "reduce-scatter" not in pa.get("gradients/data", {})
    scattered = za["gradients/data"]["reduce-scatter"]
    moved = pa["gradients/data"]["all-reduce"] \
        - za["gradients/data"]["all-reduce"]
    assert scattered > 0 and moved == 2 * scattered
    assert za["optimizer/data"]["all-gather"] == moved
    assert pa["loss/model"] == za["loss/model"]


GLOO_STEP = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import pickle
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.train import (TrainStepConfig, make_train_state_specs,
                                   make_train_step, reshard_state,
                                   train_state_from_model)

    torch.set_num_threads(1)
    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for arch in ("smollm-135m", "h2o-danube-3-4b"):
        cfg = get_arch(arch).reduced()
        tok = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32))
        with open(f"{sys.argv[3]}/{arch}.pkl", "rb") as f:
            npp = pickle.load(f)
        for zero1 in (False, True):
            ts = TrainStepConfig(zero1=zero1)
            state = reshard_state(train_state_from_model(
                cfg, params_from_numpy(cfg, npp, device="cpu"), ts),
                mesh, make_train_state_specs(cfg, mesh, ts))
            step = make_train_step(cfg, "cpu", ts, mesh=mesh)
            rows = []
            for _ in range(2):
                state, m = step(state, {"tokens": tok})
                rows.append([float(m["loss"]), float(m["grad_norm"])])
            out[f"{arch}/{zero1}"] = rows
    # the trainer on the mesh: two steps with a checkpoint each, then a
    # resumed run takes the third
    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer, TrainerConfig
    cfg = get_arch("smollm-135m").reduced()
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    runs = []
    for total in (2, 3):
        tr = Trainer(cfg, data, TrainerConfig(
            total_steps=total, checkpoint_every=1,
            checkpoint_dir=sys.argv[4], log_every=100), device="cpu",
            mesh=mesh)
        tr.run()
        runs.append([[h.step, h.loss] for h in tr.history])
    out["trainer"] = runs
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
""")


# the reference's sharded steps on the same batches, from the same
# initial weights, over 4 host devices on an Auto-axis (2, 2) mesh (its
# make_host_mesh gives Explicit axes on jax 0.9.0: ROADMAP queue 3)
REF_SHARDED = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_arch
    from repro.train.train_step import (TrainStepConfig, init_train_state,
                                        make_train_step)

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    out = {}
    for arch in ("smollm-135m", "h2o-danube-3-4b"):
        cfg = get_arch(arch).reduced()
        tok = jnp.asarray(np.random.default_rng(1).integers(
            0, cfg.vocab, (4, 32)).astype(np.int32))
        for zero1 in (False, True):
            ts = TrainStepConfig(zero1=zero1)
            with mesh:
                step, _ = make_train_step(cfg, mesh, ts, donate=False)
                state = init_train_state(cfg, jax.random.key(0), ts)
                rows = []
                for _ in range(2):
                    state, m = step(state, {"tokens": tok})
                    rows.append([float(m["loss"]), float(m["grad_norm"])])
            out[f"{arch}/{zero1}"] = rows
    print(json.dumps(out))
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference_weights(arch: str) -> dict:
    """The reference's initial weights (key 0) as numpy arrays: those of
    its ``init_train_state(cfg, jax.random.key(0))``."""
    import jax
    from repro.configs import get_arch as jget
    from repro.models import build as jbuild
    from repro.models import unbox
    params = unbox(jbuild(jget(arch).reduced()).init(jax.random.key(0)))
    return jax.tree.map(np.asarray, params)


SHARDED_ARCHS = ("smollm-135m", "h2o-danube-3-4b")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The 4 gloo processes' report (:data:`GLOO_STEP`), from the
    reference's initial weights, every rank's; the weights; the
    checkpoint directory of the trainer's runs."""
    tmp = tmp_path_factory.mktemp("sharded")
    weights = {arch: _reference_weights(arch) for arch in SHARDED_ARCHS}
    for arch, npp in weights.items():
        with open(tmp / f"{arch}.pkl", "wb") as f:
            pickle.dump(npp, f)
    ckpt = tmp / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_STEP, str(r),
                               port, str(tmp), str(ckpt)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    reps = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    return {"reps": reps, "weights": weights, "ckpt": ckpt, "tmp": tmp}


def test_sharded_steps_match_the_one_process_step(sharded):
    """(vi) two sharded train steps of reduced smollm and reduced
    h2o-danube (sequence parallel) over 4 gloo processes on a (2, 2)
    mesh, with and without zero1, from the reference's initial weights,
    against the port's one-process step on the same batch.  Every rank
    reports the same numbers, and zero1 those of the plain sharded step
    within rel 1e-6: its clip norm sums each scattered gradient's
    squares by data slice, then across them, so the float32 norm may
    differ in its last bit.  The first step's loss within rel 2e-5:
    smollm's forward is the one-process forward bit for bit; h2o's
    untied head product, cut by vocabulary, rounds a few bf16 logits one
    step otherwise (1.0e-5).  The second within rel 2e-4: AdamW's first
    update is sign(g) lr, and a gradient entry within rounding of zero
    flips its weight's move by 2 lr (h2o 1.0e-4).  The gradient norm
    within rel 1e-3."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.train import train_state_from_model

    reps = sharded["reps"]
    assert all(r == reps[0] for r in reps)
    for arch in SHARDED_ARCHS:
        cfg = get_arch(arch).reduced()
        tok = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32))
        state = train_state_from_model(cfg, params_from_numpy(
            cfg, sharded["weights"][arch], device="cpu"))
        step = make_train_step(cfg, "cpu")
        want = []
        for _ in range(2):
            state, m = step(state, {"tokens": tok})
            want.append([float(m["loss"]), float(m["grad_norm"])])
        for zrow, row in zip(reps[0][f"{arch}/True"],
                             reps[0][f"{arch}/False"]):
            assert zrow == pytest.approx(row, rel=1e-6), arch
        (l1, g1), (l2, g2) = reps[0][f"{arch}/False"]
        assert l1 == pytest.approx(want[0][0], rel=2e-5), arch
        assert l2 == pytest.approx(want[1][0], rel=2e-4), arch
        assert g1 == pytest.approx(want[0][1], rel=1e-3), arch
        assert g2 == pytest.approx(want[1][1], rel=1e-3), arch
    # the trainer on the mesh: rank 0 wrote each step's checkpoint, the
    # second run resumed after step 1 and took step 2 only; its losses
    # are those of the port's one-process trainer under the rules above
    first, resumed = reps[0]["trainer"]
    assert [s for s, _ in first] == [0, 1] and [s for s, _ in resumed] \
        == [2]
    assert sorted(p.name for p in sharded["ckpt"].iterdir()) == [
        "step_00000001", "step_00000002", "step_00000003"]
    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer, TrainerConfig
    cfg = get_arch("smollm-135m").reduced()
    one = Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4),
                  TrainerConfig(total_steps=3, checkpoint_every=10,
                                checkpoint_dir=str(sharded["tmp"] / "one"),
                                log_every=100), device="cpu")
    one.run()
    for (step, got), h in zip(first + resumed, one.history):
        assert got == pytest.approx(h.loss, rel=2e-5 if step == 0 else 2e-4)


@pytest.mark.slow
def test_sharded_steps_match_the_reference_sharded_step(sharded):
    """(vi) the same sharded steps against the reference's (its
    make_train_step on a (2, 2) Auto-axis mesh of 4 host devices, from
    the same weights on the same batch, with and without zero1) under
    the limits of the one-device comparison in test_torch_train.py: each
    loss within 1e-3, each gradient norm within rel 3e-2.  Slow: the
    reference compiles four train steps in a subprocess (about 40 s)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_PERF", None)
    out = subprocess.run([sys.executable, "-c", REF_SHARDED], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref_rows = json.loads(out.stdout.strip().splitlines()[-1])
    reps = sharded["reps"]
    for arch in SHARDED_ARCHS:
        for zero1 in (False, True):
            for (loss, gnorm), (jloss, jgnorm) in zip(
                    reps[0][f"{arch}/{zero1}"], ref_rows[f"{arch}/{zero1}"]):
                assert abs(loss - jloss) < 1e-3, (arch, zero1)
                assert gnorm == pytest.approx(jgnorm, rel=3e-2), (arch,
                                                                  zero1)


def test_plan_from_the_port_record_matches_reference(records):
    """(vii) the port's record through ``StepProfile.from_dryrun`` and
    ``plan`` gives the rows of the reference's ``plan`` fed the same
    record (its exact ``numpy`` engine)."""
    rec = records["smollm-135m"]
    kw = dict(min_terminals=256, mesh_shape=(16, 16),
              axis_names=("data", "model"))
    rows = plan(StepProfile.from_dryrun(rec), device="cpu", **kw)
    old = ref_flags().util_engine
    ref_set_flags(util_engine="numpy")
    try:
        want = RF.plan(RF.StepProfile.from_dryrun(json.loads(
            json.dumps(rec))), **kw)
    finally:
        ref_set_flags(util_engine=old)
    assert [r["fabric"] for r in rows] == [r["fabric"] for r in want]
    for row, ref in zip(rows, want):
        assert row == ref, row["fabric"]
    assert any("placed_comm_ms" in r for r in rows)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v3-671b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_skipped_cells_name_their_queue(arch):
    """What stays skipped: long_500k on a full-attention arch (the four
    MoE / MLA and memory-input configs are none of them sub-quadratic),
    as in the reference; their prefill_32k and decode_32k cells run
    (:func:`test_family_serve_cell_record`)."""
    assert not get_arch(arch).sub_quadratic
    out = dryrun.lower_cell(arch, "long_500k", False, "cpu")
    assert out["status"] == "skipped" and "sub-quadratic" in out["reason"]


def test_production_mesh_needs_its_world():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="dryrun"):
        make_production_mesh()
    with dryrun.fake_world(8):
        with pytest.raises(RuntimeError, match="256 ranks"):
            make_production_mesh(device_type="cpu")


def test_kernel_flops_formulas():
    """The kernels' products as chip_smoke.py's bounds count them, on the
    local problems booked: #5 2 mm, #6 3 mm, #7 4 mm over the live
    causal pairs; #8 and 8' by chunk; two problems of one family in a
    step whose launches do not split whole over their calls raise."""
    mm = 2.0 * 64 * 9 * 16 * (4096 * 4097 // 2)
    attn = {"attention": {(16, 9, 3, 4096, 4096, 64, None, True): 60}}
    got = dryrun.kernel_flops(attn, {"flash_attention_fwd": 60,
                                     "flash_attention_dq": 30,
                                     "flash_attention_dkv": 30})
    assert got == pytest.approx(mm * (2 * 60 + 3 * 30 + 4 * 30))
    assert dryrun._live_pairs(10, 4) == 4 * 5 // 2 + 6 * 4
    fwd, bwd = dryrun._ssd_products(512, 256, 24, 64, 1, 128)
    tri = 256 * 257 / 2
    assert fwd == pytest.approx(2 * (2 * tri * 128 + 2 * tri * 64 * 24
                                     + 4 * 256 * 128 * 64 * 24))
    assert bwd > fwd
    ssd = {"ssd": {(16, 512, 24, 64, 1, 128, 256): 48}}
    assert dryrun.kernel_flops(ssd, {"ssd_scan": 48, "ssd_scan_bwd": 24}) \
        == pytest.approx(16 * (48 * fwd + 24 * bwd))
    attn["attention"][(2, 9, 3, 4096, 4096, 64, None, True)] = 1
    with pytest.raises(ValueError, match="2 local attention problems"):
        dryrun.kernel_flops(attn, {"flash_attention_fwd": 61,
                                   "flash_attention_dq": 30})


@pytest.mark.parametrize("dp_over_model", [False, True])
def test_kernel_problems_are_the_local_blocks(dp_over_model):
    """The kernels' products come from the blocks the kernels are handed.
    Reduced smollm's 4 heads do not divide a model axis of 8, so on a
    fake (2, 8) world the heads stay whole; the batch of 32 is split over
    "data" (16 rows a device) and, under dp_over_model, over "model" too
    (2 rows), as the reference's batch_axes_for spreads it."""
    from torch.distributed.device_mesh import init_device_mesh
    old = perf.flags().dp_over_model
    perf.set_flags(dp_over_model=dp_over_model)
    try:
        with dryrun.fake_world(16):
            mesh = init_device_mesh("cpu", (2, 8),
                                    mesh_dim_names=("data", "model"))
            rec = dryrun._step_metrics(get_arch("smollm-135m").reduced(),
                                       SMALL, mesh, torch.device("cpu"))
    finally:
        perf.set_flags(dp_over_model=old)
    rows = 2 if dp_over_model else 16
    # forward and remat recompute of each of the 2 layers
    assert rec["kernel_problems"] == {
        "attention": [[rows, 4, 2, 256, 256, 32, None, True, 4]]}
    problems = {"attention": {tuple(p[:-1]): p[-1] for p in
                              rec["kernel_problems"]["attention"]}}
    mm = 2.0 * 32 * 4 * rows * (256 * 257 // 2)
    assert dryrun.kernel_flops(problems, {"flash_attention_fwd": 4,
                                          "flash_attention_dq": 2,
                                          "flash_attention_dkv": 2}) \
        == pytest.approx(mm * (2 * 4 + 3 * 2 + 4 * 2))
    assert rec["kernel_flops"] == 0        # nothing launches on the CPU


# ---------------------------------------------------------------------------
# The serve cells: prefill_32k, decode_32k and long_500k
# ---------------------------------------------------------------------------

SERVE_ARCHS = ("smollm-135m", "h2o-danube-3-4b", "mamba2-130m",
               "recurrentgemma-9b")
# the reference's dry-run cells of these tests, at reduced widths: a
# prefill of 32 rows of 256 tokens, a decode step of 128 rows against 256
# tokens of context, long_500k's one row against 300 (past reduced h2o's
# and recurrentgemma's window of 64: a ring)
SERVE_SHAPES = {"prefill_32k": ShapeConfig("prefill_32k", 256, 32,
                                           "prefill"),
                "decode_32k": ShapeConfig("decode_32k", 256, 128, "decode"),
                "long_500k": ShapeConfig("long_500k", 300, 1, "decode")}


def _serve_cell(arch: str, shape_name: str, multi_pod: bool = False):
    return dryrun.lower_cell(arch, shape_name, multi_pod, "cpu",
                             cfg=get_arch(arch).reduced(),
                             shape=SERVE_SHAPES[shape_name])


@pytest.fixture(scope="module")
def serve_records():
    return {(arch, name): _serve_cell(arch, name) for arch in SERVE_ARCHS
            for name in SERVE_SHAPES}


@pytest.mark.parametrize("shape_name", sorted(SERVE_SHAPES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_cell_record(serve_records, arch, shape_name):
    """A serve cell on a fake (16, 16) world at reduced widths: the
    train record's fields; its collectives booked under the ``prefill``
    or ``decode`` phase; rows a device (the batch over "data" where 16
    divides it); a prefill's local attention problem (square, causal, at
    the window, one call a layer) or SSD problem; a decode cell's cache
    of min(seq_len, window) slots, its local bytes leaf by leaf exactly
    the reckoning from the config (``dryrun.reckon_cache_bytes``), in the
    memory's
    parts; the arguments the parameters (and the cache), the outputs the
    local float32 logits (vocab-parallel: 512 / 16 a device) and the
    cache."""
    rec = serve_records[(arch, shape_name)]
    cfg = get_arch(arch).reduced()
    shape = SERVE_SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    kind = shape.kind
    rows = shape.global_batch // 16 if shape.global_batch % 16 == 0 else \
        shape.global_batch
    seq = 1 if kind == "decode" else shape.seq_len
    assert rec["per_device_batch"] == [rows, seq]
    coll = rec["collective_bytes_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert sum(r["bytes"] * r["count"] for r in rec["collectives"]) \
        == coll["total"] > 0
    phases = {at.split("/")[0] for at in
              rec["collective_bytes_by_phase_axis"]}
    assert phases == {kind}
    assert rec["dp_gradient_bytes"] == {}
    assert rec["flops"] == rec["aten_flops"] + rec["kernel_flops"] > 0
    assert rec["launches"] == {} and rec["kernel_flops"] == 0
    mem = rec["memory"]
    parts = mem["peak_parts"]
    logits = rows * seq * (cfg.vocab // 16) * 4
    assert parts["logits"] == logits and parts["rest"] is None
    assert mem["peak_bytes"] is None and mem["temp_bytes"] is None
    cache = sum(mem["cache_parts"].values())
    assert parts["cache"] == cache
    assert mem["output_bytes"] == logits + cache
    n_attn = sum(cfg.pattern[i % len(cfg.pattern)] == "attn"
                 for i in range(cfg.n_layers))
    if kind == "prefill":
        assert mem["argument_bytes"] == parts["params"]
        problems = rec["kernel_problems"]
        if n_attn:
            hq = cfg.n_heads // 16 if cfg.n_heads % 16 == 0 else cfg.n_heads
            hkv = cfg.n_kv_heads // 16 if cfg.n_kv_heads % 16 == 0 \
                else cfg.n_kv_heads
            assert problems == {"attention": [[
                rows, hq, hkv, seq, seq, cfg.resolved_head_dim, cfg.window,
                True, n_attn]]}
        else:
            ssm = cfg.ssm
            h = ssm.expand * cfg.d_model // ssm.head_dim
            assert problems == {"ssd": [[
                rows, seq, h // 16 if h % 16 == 0 else h, ssm.head_dim,
                ssm.n_groups, ssm.d_state, ssm.chunk, cfg.n_layers]]}
        assert rec["context"] == seq
    else:
        slots = dryrun.decode_context(cfg, shape.seq_len)
        assert rec["context"] == slots and rec["kernel_problems"] == {}
        assert mem["cache_parts"] == dryrun.reckon_cache_bytes(cfg, rows,
                                                               slots)
        assert mem["argument_bytes"] == parts["params"] + cache


def test_pod2_serve_cell():
    """h2o's decode_32k cell on a fake (2, 16, 16) world: the 128 rows
    over ("pod", "data"), 4 a device, and the cache's bytes the
    reckoning at 4 rows."""
    rec = _serve_cell("h2o-danube-3-4b", "decode_32k", multi_pod=True)
    cfg = get_arch("h2o-danube-3-4b").reduced()
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    assert rec["mesh"] == "2x16x16" and rec["per_device_batch"] == [4, 1]
    assert rec["memory"]["cache_parts"] == dryrun.reckon_cache_bytes(
        cfg, 4, cfg.window)
    assert set(rec["collective_bytes_by_phase_axis"]) <= {
        "decode/model", "decode/data", "decode/pod"}


def test_long_context_decode_writes_its_ring_slot():
    """A decode cell's cache is a prefill of seq_len - 1 tokens
    (``local_cache``): reduced h2o's ring of 64 slots at long_500k's
    short stand-in context of 300 holds positions 236 .. 298, position
    p at slot p mod 64; the step's one token at position 299 lands in
    slot 299 mod 64 = 43 of each layer's ring (kpos, computed on the
    device, carries no collective's garbage)."""
    from repro_torch.models import Model, build
    from repro_torch.train.train_step import _bind
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_arch("h2o-danube-3-4b").reduced()
    dev = torch.device("cpu")
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        cache = dryrun.local_cache(cfg, mesh, 1, 300, dev)
        kpos = cache[0]["mixer"]["kpos"].to_local()
        assert kpos.shape == (1, 64)
        assert sorted(kpos[0].tolist()) == list(range(235, 299))
        assert all(int(p) % 64 == i for i, p in enumerate(kpos[0]))
        bundle = build(cfg)
        model = Model(cfg, device="meta")
        _bind(model, dryrun.local_params(cfg, mesh, bundle.param_specs(mesh),
                                         dev))
        tok = torch.zeros((1, 1), dtype=torch.long)
        _, out = bundle.decode_step(model, cache, tok,
                                    torch.full((1, 1), 299), mesh=mesh)
    for layer in out:
        got = layer["mixer"]["kpos"].to_local()[0]
        assert int(got[299 % 64]) == 299
        assert sorted(got.tolist()) == list(range(236, 300))


REF_SERVE = textwrap.dedent(r"""
    import json, re
    from repro.launch import dryrun
    import jax
    import numpy as np
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:256]).reshape(16, 16),
                             ("data", "model"))
    shapes = {"prefill_32k": ShapeConfig("prefill_32k", 256, 32, "prefill"),
              "decode_32k": ShapeConfig("decode_32k", 256, 128, "decode")}
    ids = np.arange(256).reshape(16, 16)
    axes = {tuple(ids[0]): "model", tuple(ids[:, 0]): "data"}

    def axis(line):
        # iota form [G,S]<=[dims]T(perm), or an explicit list {{...},...}
        m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
                      r"(?:T\(([\d,]+)\))?", line)
        if m:
            g = np.arange(256).reshape([int(d) for d in m[3].split(",")])
            if m[4]:
                g = g.transpose([int(d) for d in m[4].split(",")])
            return axes.get(tuple(g.reshape(int(m[1]), int(m[2]))[0]),
                            "other")
        m = re.search(r"replica_groups=\{\{([\d,]+)\}", line)
        return axes.get(tuple(int(d) for d in m[1].split(",")), "other") \
            if m else "other"

    out = {}
    for arch in ("smollm-135m", "h2o-danube-3-4b", "mamba2-130m",
                 "recurrentgemma-9b", "granite-moe-3b-a800m",
                 "deepseek-v3-671b", "llama-3.2-vision-90b",
                 "seamless-m4t-large-v2"):
        cfg = get_arch(arch).reduced().replace(scan_layers=False)
        if cfg.vision is not None:
            cfg = cfg.replace(n_layers=10)
        for name, shape in shapes.items():
            with mesh:
                text = dryrun._lower_any(cfg, shape, mesh).compile() \
                    .as_text()
            rows = []
            for line in text.splitlines():
                m = dryrun.COLLECTIVE_RE.search(line)
                if m:
                    rows.append([m[2], dryrun.SHAPE_RE.findall(m[1]),
                                 dryrun._shape_bytes(m[1]), axis(line)])
            out[f"{arch}/{name}"] = {"bytes": dryrun.collective_bytes(text),
                                     "rows": rows}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_serve():
    """The reference's compiled serve cells (its ``_lower_prefill`` /
    ``_lower_decode`` on an Auto-axis (16, 16) mesh), layers unrolled:
    collective bytes by kind and each collective's operands."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_PERF", None)
    out = subprocess.run([sys.executable, "-c", REF_SERVE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_collectives_against_reference(serve_records, ref_serve,
                                             arch, shape_name):
    """The serve cells' collectives against the reference's compiled
    cells with their layers unrolled (each layer's collectives in the
    program once, as the port runs them), the ratio printed.  The dense
    GQA and RG-LRU archs move the reference's kinds and bytes exactly:
    all-reduces only, the vocab-parallel embedding's, each MLP's (and
    RG-LRU's gate and output) float32 partial sums.  mamba2's prefill
    all-reduces the reference's bytes exactly; GSPMD also shifts the
    conv's halo by collective-permute and gathers the in_proj weight in
    the decode step, where the port gathers the in_proj and conv weights
    in the prefill and, in decode, the one token's in_proj product and
    conv output (``SSDBlock``): the port moves fewer bytes in all, each
    collective printed under ``-s``."""
    rec = serve_records[(arch, shape_name)]
    got = rec["collective_bytes_per_device"]
    want = ref_serve[f"{arch}/{shape_name}"]["bytes"]
    print(f"\n{arch} {shape_name}: port {json.dumps(got)}; reference "
          f"unrolled {json.dumps(want)}; ratio "
          f"{got['total'] / want['total']:.4f}")
    if arch != "mamba2-130m":
        assert got == want
        return
    for r in rec["collectives"]:
        print(f"  port  {r['at']:18s} {r['kind']:18s} {r['shape']:24s} "
              f"{r['bytes']:>8,} B x {r['count']}")
    for kind, shapes, nbytes, _ in ref_serve[f"{arch}/{shape_name}"][
            "rows"]:
        print(f"  ref   {kind:18s} {nbytes:>8,} B: {shapes[:4]}")
    assert set(got) <= {"all-reduce", "all-gather", "total"}
    assert got["total"] < want["total"]
    if shape_name == "prefill_32k":
        assert got["all-reduce"] == want["all-reduce"]


def test_plan_from_a_serve_record_matches_reference(serve_records):
    """h2o's decode record through ``StepProfile.from_dryrun`` and
    ``plan`` gives the rows of the reference's ``plan`` fed the same
    record (its exact ``numpy`` engine)."""
    rec = serve_records[("h2o-danube-3-4b", "decode_32k")]
    kw = dict(min_terminals=256, mesh_shape=(16, 16),
              axis_names=("data", "model"))
    rows = plan(StepProfile.from_dryrun(rec), device="cpu", **kw)
    old = ref_flags().util_engine
    ref_set_flags(util_engine="numpy")
    try:
        want = RF.plan(RF.StepProfile.from_dryrun(json.loads(
            json.dumps(rec))), **kw)
    finally:
        ref_set_flags(util_engine=old)
    assert rows == want


# ---------------------------------------------------------------------------
# The serve cells of the MoE / MLA and memory-input families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("granite-moe-3b-a800m", "deepseek-v3-671b",
                "llama-3.2-vision-90b", "seamless-m4t-large-v2")
# the reference's figures of these cells at reduced widths (vision at ten
# layers), unrolled: collective bytes a device by kind
REF_FAMILY_BYTES = {
    "granite-moe-3b-a800m/prefill_32k": {
        "all-gather": 1_507_328, "all-to-all": 327_680, "total": 1_835_008},
    "granite-moe-3b-a800m/decode_32k": {
        "all-reduce": 684_032, "collective-permute": 16_384,
        "all-gather": 24_576, "total": 724_992},
    "deepseek-v3-671b/prefill_32k": {
        "all-reduce": 524_288, "all-gather": 917_504, "all-to-all": 327_680,
        "total": 1_769_472},
    "deepseek-v3-671b/decode_32k": {
        "all-reduce": 696_320, "collective-permute": 16_384,
        "all-gather": 24_576, "total": 737_280},
    "llama-3.2-vision-90b/prefill_32k": {"all-reduce": 2_883_584,
                                         "total": 2_883_584},
    "llama-3.2-vision-90b/decode_32k": {"all-reduce": 45_056,
                                        "total": 45_056},
    "seamless-m4t-large-v2/prefill_32k": {"all-reduce": 917_504,
                                          "total": 917_504},
    "seamless-m4t-large-v2/decode_32k": {"all-reduce": 12_288,
                                         "total": 12_288}}


def _family_cfg(arch):
    cfg = get_arch(arch).reduced()
    # reduced() keeps 4 of vision's layers, and so no cross layer
    return cfg.replace(n_layers=10) if cfg.vision is not None else cfg


def _family_cell(arch: str, shape_name: str, multi_pod: bool = False):
    return dryrun.lower_cell(arch, shape_name, multi_pod, "cpu",
                             cfg=_family_cfg(arch),
                             shape=SERVE_SHAPES[shape_name])


@pytest.fixture(scope="module")
def family_records():
    return {(arch, name): _family_cell(arch, name) for arch in FAMILY_ARCHS
            for name in ("prefill_32k", "decode_32k")}


def _family_problems(cfg, kind: str, rows: int) -> dict:
    """The local kernel problems a serve cell of ``cfg`` books on the
    fake (16, 16) world at reduced widths (4 heads, 2 kv heads, none
    split over 16): the self-attention's causal square (MLA's at q/k 32
    and v 16) a layer in prefill, each cross layer's non-causal problem
    against the memory's length (Sq = 1 in decode), the encoder's
    non-causal square in prefill."""
    from repro_torch.models.transformer import layer_plan
    kinds = layer_plan(cfg).kinds
    seq = 1 if kind == "decode" else 256
    n_mem = dryrun.memory_tokens(cfg, 256)
    d = cfg.resolved_head_dim
    if cfg.mla is not None:
        mla = cfg.mla
        return {} if kind == "decode" else {"mla": [[
            rows, 4, seq, seq, mla.qk_nope + mla.qk_rope, mla.v_head,
            len(kinds)]]}
    rows_out = []
    if cfg.encoder is not None and kind == "prefill":
        rows_out.append([rows, 4, 2, n_mem, n_mem, d, None, False,
                         cfg.encoder.n_layers])
    n_self = sum(k in ("attn", "dec_xattn") for k in kinds)
    if kind == "prefill":
        rows_out.append([rows, 4, 2, seq, seq, d, None, True, n_self])
    n_cross = sum(k in ("xattn", "dec_xattn") for k in kinds)
    if n_cross:
        rows_out.append([rows, 4, 2, seq, n_mem, d, None, False, n_cross])
    return {"attention": rows_out} if rows_out else {}


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_serve_cell_record(family_records, arch, shape_name):
    """The serve cells of the MoE / MLA and memory-input families on a
    fake (16, 16) world at reduced widths (vision at ten layers) and the
    small shapes of :data:`SERVE_SHAPES`: the train record's fields; the
    collectives booked under the cell's phase; 2 rows a device in
    prefill, 8 in decode; the memory of ``memory_tokens`` rows (16
    image tokens, 256 / 4 = 64 frames) carried, its local bytes in
    ``peak_parts``; the local kernel problems (:func:`_family_problems`:
    the cross and encoder problems non-causal at Sq x Skv, MLA's at its
    own heads); a decode cell's cache (MLA's latents at 256 slots, the
    cross layers' k and v and ``enc_memory`` at the memory's length)
    leaf by leaf exactly the reckoning from the config
    (``dryrun.reckon_cache_bytes``)."""
    rec = family_records[(arch, shape_name)]
    cfg = _family_cfg(arch)
    shape = SERVE_SHAPES[shape_name]
    kind = shape.kind
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    rows = shape.global_batch // 16
    seq = 1 if kind == "decode" else shape.seq_len
    assert rec["per_device_batch"] == [rows, seq]
    coll = rec["collective_bytes_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert sum(r["bytes"] * r["count"] for r in rec["collectives"]) \
        == coll["total"] > 0
    assert {at.split("/")[0] for at in
            rec["collective_bytes_by_phase_axis"]} == {kind}
    assert rec["dp_gradient_bytes"] == {}
    assert rec["flops"] == rec["aten_flops"] + rec["kernel_flops"] > 0
    assert rec["launches"] == {} and rec["kernel_flops"] == 0
    n_mem = dryrun.memory_tokens(cfg, shape.seq_len)
    assert rec["memory_tokens"] == n_mem
    mem = rec["memory"]
    parts = mem["peak_parts"]
    logits = rows * seq * (cfg.vocab // 16) * 4
    assert parts["logits"] == logits and parts["rest"] is None
    assert parts.get("memory", 0) == rows * n_mem * cfg.d_model * 2
    cache = sum(mem["cache_parts"].values())
    assert parts["cache"] == cache
    assert mem["output_bytes"] == logits + cache
    assert rec["kernel_problems"] == _family_problems(cfg, kind, rows)
    if kind == "prefill":
        assert rec["context"] == seq
        assert mem["argument_bytes"] == parts["params"] + parts.get(
            "memory", 0)
    else:
        slots = dryrun.decode_context(cfg, shape.seq_len)
        assert rec["context"] == slots == shape.seq_len
        assert mem["cache_parts"] == dryrun.reckon_cache_bytes(
            cfg, rows, slots, memory_len=n_mem)
        assert mem["argument_bytes"] == parts["params"] + cache


def test_family_pod2_serve_cell():
    """deepseek-v3's decode_32k cell on a fake (2, 16, 16) world: the
    128 rows over ("pod", "data"), 4 a device; the latents' bytes the
    reckoning at 4 rows; the MoE's float32 bins all-reduced over both
    batch axes, its router logits all-gathered over them, and no expert
    weight gathered."""
    rec = _family_cell("deepseek-v3-671b", "decode_32k", multi_pod=True)
    cfg = _family_cfg("deepseek-v3-671b")
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    assert rec["mesh"] == "2x16x16" and rec["per_device_batch"] == [4, 1]
    assert rec["memory"]["cache_parts"] == dryrun.reckon_cache_bytes(
        cfg, 4, 256)
    by = rec["collective_bytes_by_phase_axis"]
    assert set(by) <= {"decode/model", "decode/data", "decode/pod"}
    bins = [r for r in rec["collectives"] if r["kind"] == "all-reduce"
            and r["shape"] == "f32[8,40,128]"]
    assert {r["at"] for r in bins} == {"decode/data", "decode/pod"}
    assert all(r["count"] == 4 for r in bins)
    _no_expert_weight_gathered(cfg, rec)


def _no_expert_weight_gathered(cfg, rec):
    """Every all-gather of a MoE decode cell is of the router's float32
    logits, (rows, E), one a batch axis and MoE layer (over "data", then
    "pod" on the 2 x 16 x 16 mesh): no expert weight moves."""
    from repro_torch.models.transformer import layer_plan
    t, e = SERVE_SHAPES["decode_32k"].global_batch, cfg.moe.n_experts
    gathers = [r for r in rec["collectives"] if r["kind"] == "all-gather"]
    shapes = {r["shape"] for r in gathers}
    assert shapes <= {f"f32[{t // n},{e}]" for n in (1, 2)}, gathers
    n_axes = len(rec["mesh"].split("x")) - 1
    assert sum(r["count"] for r in gathers) == \
        sum(layer_plan(cfg).has_moe) * n_axes


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v3-671b"])
def test_moe_decode_gathers_no_expert_weight(family_records, arch):
    """The MoE decode cell (128 tokens on 256 devices: the global scatter
    path) as the reference's compiled cell lays it out: the router's
    logits all-gathered over ``data``, the bins (E, C, M) = (8, 40, 128)
    float32 all-reduced over ``data`` twice a MoE layer (each device's
    rows scattered, then the experts' ``expert_ff`` partial sums), and
    no expert weight gathered: the only all-gathers are the logits'."""
    rec = family_records[(arch, "decode_32k")]
    cfg = _family_cfg(arch)
    _no_expert_weight_gathered(cfg, rec)
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import layer_plan
    c = capacity(128, cfg.moe)
    bins = [r for r in rec["collectives"] if r["kind"] == "all-reduce"
            and r["shape"] == f"f32[{cfg.moe.n_experts},{c},{cfg.d_model}]"]
    assert [(r["at"], r["count"]) for r in bins] == [
        ("decode/data", 2 * sum(layer_plan(cfg).has_moe))]


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_collectives_against_reference(family_records, ref_serve,
                                              arch, shape_name):
    """The families' serve cells against the reference's compiled cells
    with their layers unrolled (:data:`REF_FAMILY_BYTES` pins its
    figures), each collective printed under ``-s``.  vision and seamless
    move the reference's kinds and bytes exactly: the vocab-parallel
    embedding's and each MLP's float32 partial sums (the embedding's
    reduced in float32, a bf16 table's too, as the reference's program
    reduces it).  The MoE cells lay out the reference's MoE layers:
    in prefill the expert weights' all-gathers over ``data`` are the
    reference's (each device's experts cut before the gather; deepseek's
    bf16 weights move half the reference's float32 bytes) and the bins'
    all-to-all half its bytes (bf16 bins, where XLA moves the float32
    casts of ``_expert_mlp_any`` before the exchange); in decode the
    router's float32 logits all-gathered and the (E, C, M) float32 bins
    all-reduced over ``data`` as there, row for row.  The rest is
    GSPMD's own choice (the embedding table gathered, q / k / v
    gathered, the shared expert's weights gathered over ``model``; the
    one-hot's int32 gather, collective-permutes and small all-reduces of
    the scatter path's combine), where the port reduces partial sums:
    PERF.md section 6 lists them; the port moves fewer bytes in all."""
    rec = family_records[(arch, shape_name)]
    got = rec["collective_bytes_per_device"]
    ref = ref_serve[f"{arch}/{shape_name}"]
    want = ref["bytes"]
    assert want == REF_FAMILY_BYTES[f"{arch}/{shape_name}"]
    print(f"\n{arch} {shape_name}: port {json.dumps(got)}; reference "
          f"unrolled {json.dumps(want)}; ratio "
          f"{got['total'] / want['total']:.4f}")
    for r in rec["collectives"]:
        print(f"  port  {r['at']:18s} {r['kind']:18s} {r['shape']:24s} "
              f"{r['bytes']:>8,} B x {r['count']}")
    for kind, shapes, nbytes, axis in ref["rows"]:
        print(f"  ref   {axis:18s} {kind:18s} {nbytes:>8,} B: {shapes[:4]}")
    cfg = _family_cfg(arch)
    if cfg.moe is None:
        assert got == want
        return
    assert got["total"] < want["total"]
    ref_rows = lambda kind, axis: sorted(
        (shapes[0][1], nbytes) for k, shapes, nbytes, a in ref["rows"]
        if k == kind and a == axis)
    port_rows = lambda kind, at: sorted(
        (r["shape"].split("[")[1][:-1], r["bytes"])
        for r in rec["collectives"] if r["kind"] == kind and r["at"] == at
        for _ in range(r["count"]))
    if shape_name == "prefill_32k":
        assert got["all-to-all"] * 2 == want["all-to-all"]
        ratio = 2 if cfg.bf16_params else 1
        gathers = port_rows("all-gather", "prefill/data")
        ref_gathers = ref_rows("all-gather", "data")
        assert len(gathers) == len(ref_gathers) == 6
        assert sum(b for _, b in gathers) * ratio == sum(
            b for _, b in ref_gathers)
    else:
        for kind, shape in (("all-reduce", "8,40,128"),
                            ("all-gather", "128,8")):
            assert [r for r in port_rows(kind, "decode/data")
                    if r[0] == shape] == [
                r for r in ref_rows(kind, "data") if r[0] == shape]
