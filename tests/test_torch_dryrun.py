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


def test_skipped_cells_name_their_queue():
    out = dryrun.lower_cell("recurrentgemma-9b", "prefill_32k", False,
                            "cpu")
    assert out["status"] == "skipped" and "ROADMAP" in out["reason"]
    out = dryrun.lower_cell("smollm-135m", "decode_32k", False, "cpu")
    assert out["status"] == "skipped" and "ROADMAP" in out["reason"]
    out = dryrun.lower_cell("smollm-135m", "long_500k", False, "cpu")
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
