"""The production-mesh dry run of the RG-LRU and the memory-input
families (``repro_torch.launch.dryrun``) against the reference on the
CPU: reduced recurrentgemma-9b, llama-3.2-vision-90b at ten layers
(``reduced()`` keeps four and no cross layer) and seamless-m4t-large-v2
at 32 rows of 256 tokens on a fake (16, 16) world, their batches
carrying the memory as the reference's ``input_specs`` give it.  The
reference's compiled programs run unrolled on an Auto-axis (16, 16)
mesh in a subprocess (its ``make_production_mesh`` gives Explicit axes
on jax 0.9.0, ROADMAP queue 3), as ``tests/test_torch_dryrun.py`` runs
them."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch import dryrun

SRC = Path(__file__).resolve().parents[1] / "src"
SMALL = ShapeConfig("t", 256, 32, "train")
RGEMMA, VISION, SEAMLESS = ("recurrentgemma-9b", "llama-3.2-vision-90b",
                            "seamless-m4t-large-v2")
ARCHS = (RGEMMA, VISION, SEAMLESS)


def _cfg(arch):
    cfg = get_arch(arch).reduced()
    return cfg.replace(n_layers=10) if arch == VISION else cfg


@pytest.fixture(autouse=True)
def _one_thread_no_group():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    assert not dist.is_initialized()
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


REF_DRYRUN = textwrap.dedent("""
    import json
    from repro.launch import dryrun
    import jax
    import numpy as np
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:256]).reshape(16, 16),
                             ("data", "model"))
    shape = ShapeConfig("t", 256, 32, "train")
    out = {}
    for arch, n_layers in (("recurrentgemma-9b", None),
                           ("llama-3.2-vision-90b", 10),
                           ("seamless-m4t-large-v2", None)):
        cfg = get_arch(arch).reduced().replace(scan_layers=False)
        if n_layers:
            cfg = cfg.replace(n_layers=n_layers)
        with mesh:
            text = dryrun._lower_any(cfg, shape, mesh).compile().as_text()
        out[arch] = dryrun.collective_bytes(text)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_bytes():
    """The reference's unrolled programs' collective bytes (started
    first, so that they compile while the port's cells run)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_PERF", None)
    proc = subprocess.Popen([sys.executable, "-c", REF_DRYRUN], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def records(ref_bytes):
    return {arch: dryrun.lower_cell(arch, "t", False, "cpu",
                                    cfg=_cfg(arch), shape=SMALL)
            for arch in ARCHS}


@pytest.fixture(scope="module")
def ref(ref_bytes, records):
    out, err = ref_bytes.communicate(timeout=600)
    assert ref_bytes.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _dp_bytes(cfg) -> int:
    """The gradients, in the parameters' dtype, of the local blocks on
    (16, 16) not sharded over ``data``: every leaf the loss reads (the
    0-d cross gates among them)."""
    from repro_torch.models import build
    from repro_torch.models.common import local_shape
    from repro_torch.models.model import param_shapes
    mesh = {"data": 16, "model": 16}
    specs = build(cfg).param_specs(mesh)
    total = 0
    for name, (shape, dt) in param_shapes(cfg).items():
        flat = [a for e in specs[name] if e
                for a in ((e,) if isinstance(e, str) else e)]
        if "data" not in flat:
            total += int(np.prod(local_shape(shape, specs[name], mesh))) \
                * torch.empty((), dtype=dt).element_size()
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_data_parallel_bytes_exact(records, arch):
    """Each cell runs (``status: "ok"``) and its gradient phase's
    all-reduce over ``data`` is the gradients of exactly the local
    parameters not sharded there (vision's 0-d bf16 gates included: 2
    bytes each), no more; the record's totals add up."""
    rec = records[arch]
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["per_device_batch"] == [2, 256]
    assert rec["dp_gradient_bytes"] == {"all-reduce": _dp_bytes(_cfg(arch))}
    coll = rec["collective_bytes_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert sum(r["bytes"] * r["count"] for r in rec["collectives"]) \
        == coll["total"]


# the port's total against the reference's unrolled program's, by arch
# (see the test's docstring)
TOTAL_RATIO = {RGEMMA: (0.5, 2.0), SEAMLESS: (0.5, 2.0), VISION: (0.45, 2.0)}


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_against_the_reference(records, ref, arch):
    """The cells' collectives against the reference's compiled program,
    unrolled (every layer's collectives once, as the port runs them):
    the reference's kinds are the port's, but the reduce-scatters the
    port adds where a sequence-parallel block reduces its output
    (recurrentgemma's attention blocks, vision's; the reference
    all-reduces there and slices); totals within 2x (recurrentgemma
    0.83, seamless 1.0008).  recurrentgemma's RG-LRU gates are reduced
    as the reference's HLO reduces them: the float32 partial sums of
    ``xc @ w_a`` and ``xc @ w_i`` by all-reduce (the reference fuses the
    two into one), their gradients by float32 all-gather (the
    reference's program gathers each twice, 8 to the port's 4).
    vision's total is 0.49x the reference's: at these widths (4 heads on
    a 16-way ``model`` axis) GSPMD splits
    the work of the layers' replicated heads over ``model`` and
    all-reduces their weight gradients there (the (256, 128) MLP
    gradients in float32 among them, 11.8 MB more of all-reduce), which
    the port, its heads replicated, does not; its all-gathers are 0.91x
    the reference's.  Every kind is printed under ``-s`` as port /
    reference."""
    got = records[arch]["collective_bytes_per_device"]
    want = ref[arch]
    print(f"\n{arch}: " + ", ".join(
        f"{k} {got.get(k, 0):,} / {want.get(k, 0):,} B"
        for k in sorted(set(got) | set(want))))
    assert set(want) - {"total"} <= set(got)
    assert set(got) - set(want) <= {"reduce-scatter"}
    if arch == RGEMMA:
        # the gates: per RG-LRU layer and pass (forward, recompute) one
        # float32 all-reduce of each (2, 256, 128) partial sum, and per
        # layer one all-gather of each gate's float32 gradient
        rows = {(r["kind"], r["shape"]): r["count"]
                for r in records[arch]["collectives"]
                if r["at"] == "loss/model"}
        assert rows[("all-gather", "f32[32,256,8]")] == 2 * 2
        assert rows[("all-reduce", "f32[2,256,128]")] >= 2 * 2 * 2
    if arch == SEAMLESS:
        assert set(got) == set(want)
    lo, hi = TOTAL_RATIO[arch]
    assert lo <= got["total"] / want["total"] <= hi
    if arch == VISION:
        assert 0.5 <= got["all-gather"] / want["all-gather"] <= 2.0


# the local attention problems of the cells (B, Hq, Hkv, Sq, Skv, D,
# window, causal, calls): forward and remat recompute of each layer
PROBLEMS = {
    RGEMMA: [[2, 4, 1, 256, 256, 32, 64, True, 2]],
    VISION: [[2, 4, 2, 256, 256, 32, None, True, 16],
             [2, 4, 2, 256, 16, 32, None, False, 4]],
    SEAMLESS: [[2, 4, 2, 64, 64, 32, None, False, 4],
               [2, 4, 2, 256, 256, 32, None, True, 4],
               [2, 4, 2, 256, 64, 32, None, False, 4]],
}


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_problems_and_memory(records, arch):
    """The kernels' local problems as the step handed them: the one
    attention layer of reduced recurrentgemma (window 64, its heads
    replicated: 4 do not divide 16, MQA's one kv head); vision's 8 self
    layers and 2 cross layers (Sq 256 against the 16 image tokens,
    non-causal); seamless's encoder (64 frames, non-causal), decoder
    self and cross layers.  Each batch carries its memory (16 image
    tokens, 256 / 4 frames).  On the CPU the peak's parts are the state
    and the logits and their gradient (2 rows x 256 x 512 / 16 float32,
    twice), counted; the measured parts are the card's."""
    rec = records[arch]
    assert rec["kernel_problems"] == {"attention": PROBLEMS[arch]}
    assert rec["memory_tokens"] == {RGEMMA: 0, VISION: 16,
                                    SEAMLESS: 64}[arch]
    parts = rec["memory"]["peak_parts"]
    assert parts == {"state": rec["memory"]["argument_bytes"],
                     "saved_activations": None,
                     "logits_and_gradient": 2 * 2 * 256 * 32 * 4,
                     "rest": None}
    assert rec["kernel_flops"] == 0        # nothing launches on the CPU


def test_kernel_flops_count_non_causal_problems():
    """A non-causal problem's products over all Sq x Skv pairs, a causal
    one's over the live causal pairs; a family's launches split over its
    problems by their calls (each call forward and recompute, one
    backward): vision's 80 self and 20 cross layers at full width, rank
    0's share.  A split that is not whole raises, and so do a causal
    problem that is not square and a non-causal one with a window."""
    b, h, s, t, d = 16, 4, 4096, 1600, 128
    problems = {"attention": {(b, h, 1, s, s, d, None, True): 160,
                              (b, h, 1, s, t, d, None, False): 40}}
    launches = {"flash_attention_fwd": 200, "flash_attention_dq": 100,
                "flash_attention_dkv": 100}
    causal = 2.0 * h * b * (s * (s + 1) // 2) * d
    cross = 2.0 * h * b * (s * t) * d
    want = (causal * (160 * 2 + 80 * 3 + 80 * 4)
            + cross * (40 * 2 + 20 * 3 + 20 * 4))
    assert dryrun.kernel_flops(problems, launches) == pytest.approx(want)
    assert dryrun.kernel_padding_flops(problems, launches) == 0.0
    with pytest.raises(ValueError, match="do not split"):
        dryrun.kernel_flops(problems, dict(launches,
                                           flash_attention_dq=101))
    with pytest.raises(ValueError, match="square"):
        dryrun.kernel_flops({"attention": {(b, h, 1, s, t, d, None, True):
                                           2}}, launches)
    with pytest.raises(ValueError, match="window"):
        dryrun.kernel_flops({"attention": {(b, h, 1, s, t, d, 64, False):
                                           2}}, launches)


def test_memory_tokens_are_the_reference_input_specs():
    """The memory a train row carries: vision's 1600 image tokens,
    seamless's 4096 // 4 frames, none for recurrentgemma; the memory is
    bf16 (B, T, d_model), as the reference's ``input_specs``, and so is
    the data pipeline's ``batch_specs``."""
    from repro.configs import get_arch as ref_get_arch
    from repro.models import build as ref_build
    shape = ShapeConfig("train_4k", 4096, 256, "train")
    for arch in ARCHS:
        n = dryrun.memory_tokens(get_arch(arch), shape.seq_len)
        specs = ref_build(ref_get_arch(arch)).input_specs(shape)["batch"]
        if n:
            assert specs["memory"].shape == (256, n,
                                             get_arch(arch).d_model)
            assert str(specs["memory"].dtype) == "bfloat16"
        else:
            assert "memory" not in specs
    assert dryrun.memory_tokens(get_arch(VISION), 4096) == 1600
    assert dryrun.memory_tokens(get_arch(SEAMLESS), 4096) == 1024
    from repro_torch.data import DataConfig, batch_specs
    for arch in (VISION, SEAMLESS):
        cfg = get_arch(arch)
        mine = batch_specs(DataConfig(
            vocab=cfg.vocab, seq_len=4096, global_batch=256,
            memory_tokens=dryrun.memory_tokens(cfg, 4096),
            d_model=cfg.d_model))["memory"]
        want = ref_build(ref_get_arch(arch)).input_specs(shape)["batch"]
        assert tuple(mine.shape) == want["memory"].shape
        assert mine.dtype == torch.bfloat16


def test_mesh_batch_carries_the_memory():
    """The mesh step's batch (``train_step._mesh_batch``) keeps a
    memory-input config's memory: a bf16 DTensor over the batch axes,
    each rank holding its rows, as the reference's ``in_shardings``
    place it; a batch with no memory gets none."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.train.train_step import _mesh_batch
    tok = np.arange(4 * 8).reshape(4, 8)
    mem = np.arange(4 * 3 * 16, dtype=np.float32).reshape(4, 3, 16)
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out = _mesh_batch({"tokens": tok, "memory": mem}, mesh)
        plain = _mesh_batch({"tokens": tok}, mesh)
    assert set(out) == {"tokens", "memory"} and set(plain) == {"tokens"}
    m = out["memory"]
    assert isinstance(m, DTensor) and m.dtype == torch.bfloat16
    assert tuple(m.shape) == (4, 3, 16)
    assert tuple(m.placements) == (Shard(0), Replicate())
    assert torch.equal(m.to_local().float(), torch.from_numpy(mem[:2]))


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_reads_the_records(records, arch):
    """``fabric.plan`` on each record (``StepProfile.from_dryrun``, 256
    terminals, the (16, 16) mesh placed) gives the rows of the
    reference's ``plan`` fed the same record (its exact ``numpy``
    engine)."""
    import repro.fabric as RF
    from repro.perf import flags as ref_flags
    from repro.perf import set_flags as ref_set_flags

    from repro_torch.fabric import StepProfile, plan
    rec = records[arch]
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
    for row, w in zip(rows, want):
        assert row == w, row["fabric"]
