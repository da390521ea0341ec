"""The sharded train step's ``microbatch`` flag and ``grad_compress``
(``repro_torch.train.train_step._make_mesh_step``,
``repro_torch.optim.ef_compress_grads`` on DTensors) on the CPU.

Four gloo processes run a (2, 2) ("data", "model") mesh once for the
module (:data:`GLOO`): reduced smollm-135m at B 4, S 16 under
``microbatch=2`` (the batch as a global array and as a DTensor, which
the step routes into its microbatches by all-to-all), reduced
granite-moe-3b-a800m at ``microbatch=2`` and 1, ``grad_compress`` alone,
with ``zero1`` and with ``microbatch=2``, the ragged microbatch, the
microbatch routing on a (pod, data, model) mesh, ``ef_compress_grads``
at every placement of reduced smollm's and h2o-danube's parameter specs,
and the trainer under both flags, crashed after a checkpoint and
resumed.  Each is held against the port's one-process step under the
same flags; the bytes of a microbatched production-mesh step against
the plain one on a fake (16, 16) world, and the launcher's compressed
step on a fake 256-rank world.  The reference's sharded
microbatched step (its ``make_train_step`` on an Auto-axis (2, 2) mesh
of 4 host devices, ``REPRO_PERF=microbatch=2``) runs under ``-m
slow``."""

from __future__ import annotations

import contextlib
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
from repro_torch.train import (TrainStepConfig, make_train_step,
                               train_state_from_model)

SRC = Path(__file__).resolve().parents[1] / "src"
SMOLLM, GRANITE, H2O = ("smollm-135m", "granite-moe-3b-a800m",
                        "h2o-danube-3-4b")
# the steps' batch: 4 rows of 16 tokens; the ragged case's 6 rows
ROWS, SEQ, ODD_ROWS = 4, 16, 6
# the reference's dry-run cell of tests/test_torch_dryrun.py: 32 rows of
# 256 tokens, 2 a device on the (16, 16) mesh
SMALL = ShapeConfig("t", 256, 32, "train")
# the float32 gradients of the local parameters of reduced smollm that
# are not sharded over "data" on the (16, 16) mesh
SMOLLM_DP_BYTES = 461_312
# the step cases of the gloo run: (arch, TrainStepConfig keywords,
# microbatch)
CASES = {"mb2": (SMOLLM, {}, 2), "mb1": (SMOLLM, {}, 1),
         "gc": (SMOLLM, {"grad_compress": True}, 1),
         "gc_zero1": (SMOLLM, {"grad_compress": True, "zero1": True}, 1),
         "gc_mb2": (SMOLLM, {"grad_compress": True}, 2)}


@pytest.fixture(autouse=True)
def _one_thread_no_group():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    assert not dist.is_initialized()
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def _microbatch(mb: int):
    old = perf.flags().microbatch
    perf.set_flags(microbatch=mb)
    try:
        yield
    finally:
        perf.set_flags(microbatch=old)


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


def _granite_cfg():
    """Reduced granite with a capacity factor of 8: no pick dropped, as
    the one-process route drops none (``test_torch_moe_mesh.py``)."""
    from test_torch_moe_mesh import _step_cfg
    return _step_cfg(GRANITE, 8.0)


def _tokens(vocab: int, rows: int = ROWS, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (rows, SEQ))


GLOO = textwrap.dedent("""
    import json, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    torch.set_num_threads(1)
    rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    from repro_torch import perf
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import DataConfig
    from repro_torch.launch.dryrun import CollectiveCounter
    from repro_torch.models import build
    from repro_torch.models.common import placements
    from repro_torch.optim import ef_compress_grads, gather_bytes
    from repro_torch.train import (TrainStepConfig, Trainer, TrainerConfig,
                                   make_train_state_specs, make_train_step,
                                   reshard_state, train_state_from_model)
    from repro_torch.train.train_step import _phase, _split_rows, batch_pspec

    with open(f"{tmp}/job.pkl", "rb") as f:
        job = pickle.load(f)
    out = {}

    def run(cfg, tree, ts_kw, mb, tokens, n=2, dtensor=False):
        ts = TrainStepConfig(**ts_kw)
        perf.set_flags(microbatch=mb)
        try:
            state = reshard_state(train_state_from_model(
                cfg, params_from_numpy(cfg, tree, device="cpu"), ts), mesh,
                make_train_state_specs(cfg, mesh, ts))
            step = make_train_step(cfg, "cpu", ts, mesh=mesh)
            batch = {"tokens": tokens}
            if dtensor:
                batch = {"tokens": distribute_tensor(
                    torch.as_tensor(tokens), mesh,
                    placements(batch_pspec(mesh), mesh))}
            rows = []
            for _ in range(n):
                state, m = step(state, batch)
                rows.append({k: float(v) for k, v in m.items()})
            return rows, state
        finally:
            perf.set_flags(microbatch=1)

    smollm_cfg, smollm_tree, tok = job["smollm"]
    for key, (ts_kw, mb) in job["cases"].items():
        rows, state = run(smollm_cfg, smollm_tree, ts_kw, mb, tok)
        out[key] = rows
        if "ef" in state:
            out[key + "/ef_placed"] = all(
                tuple(state["ef"][n].placements)
                == tuple(p.placements)
                and state["ef"][n].to_local().shape == p.to_local().shape
                for n, p in state["params"].items())
    out["mb2_dtensor"] = run(smollm_cfg, smollm_tree, {}, 2, tok,
                             dtensor=True)[0]
    # the ragged microbatch: 1 row of a microbatch over 2 data ranks
    try:
        run(smollm_cfg, smollm_tree, {}, 4, tok, n=1)
        out["ragged"] = None
    except ValueError as e:
        out["ragged"] = str(e)
    # 6 rows, which 4 does not divide: the plain step
    odd = job["odd"]
    out["odd_mb4"] = run(smollm_cfg, smollm_tree, {}, 4, odd, n=1)[0]
    out["odd_mb1"] = run(smollm_cfg, smollm_tree, {}, 1, odd, n=1)[0]

    granite_cfg, granite_tree, gtok = job["granite"]
    for mb in (2, 1):
        out[f"granite/mb{mb}"] = run(granite_cfg, granite_tree, {}, mb,
                                     gtok, n=1)[0]

    # the routing on meshes of one and of two batch axes
    x = torch.arange(16 * 3).reshape(16, 3)
    routed = {}
    for shape, names in (((2, 2), ("data", "model")),
                         ((2, 2, 1), ("pod", "data", "model"))):
        m3 = init_device_mesh("cpu", shape, mesh_dim_names=names)
        xd = distribute_tensor(x, m3, placements(batch_pspec(m3), m3))
        for mb in (2, 4):
            parts = _split_rows(xd, m3, mb)
            routed[f"{len(shape)}/{mb}"] = all(
                isinstance(p, DTensor)
                and tuple(p.placements) == tuple(xd.placements)
                and torch.equal(p.full_tensor(), c)
                for p, c in zip(parts, x.chunk(mb)))
    out["routed"] = routed

    # ef_compress_grads at every placement of the two archs' specs, and
    # at placements they do not give (two sharded dims, an aligned and
    # an unaligned first dim)
    from repro_torch.models.model import param_shapes
    leaves = {arch: {name: (shape, placements(
        build(cfg).param_specs(mesh)[name], mesh))
        for name, (shape, _) in sorted(param_shapes(cfg).items())}
        for arch, cfg in job["compress"].items()}
    R, S0, S1 = Replicate(), Shard(0), Shard(1)
    leaves["extra"] = {"two_dims": ((8, 256), (S0, S1)),
                       "aligned": ((512, 3), (R, S0)),
                       "rows": ((6, 5), (S0, R)),
                       "cols": ((6, 200), (R, S1))}
    for arch, named in leaves.items():
        equal, gathered, reckoned = True, [], 0
        with CollectiveCounter(mesh) as counter:
            for i, (name, (shape, pl)) in enumerate(named.items()):
                rng = np.random.default_rng(i)
                g = torch.from_numpy(rng.normal(size=shape).astype(
                    np.float32))
                e = torch.from_numpy(1e-3 * rng.normal(size=shape).astype(
                    np.float32))
                gd = distribute_tensor(g, mesh, pl)
                ed = distribute_tensor(e, mesh, pl)
                with _phase("compress"):
                    gn, en = ef_compress_grads({name: gd}, {name: ed})
                want_g, want_e = ef_compress_grads({name: g}, {name: e})
                gb = gather_bytes(tuple(shape), pl, mesh)
                if gb:
                    gathered.append(name)
                    reckoned += sum(gb)
                with _phase("check"):
                    equal &= (tuple(gn[name].placements) == pl
                              and tuple(en[name].placements) == pl
                              and torch.equal(gn[name].full_tensor(),
                                              want_g[name])
                              and torch.equal(en[name].full_tensor(),
                                              want_e[name]))
        booked = sum(sum(v.values()) for k, v in
                     counter.by_phase_axis.items()
                     if k.startswith("compress/"))
        out[f"compress/{arch}"] = {"equal": bool(equal),
                                   "gathered": gathered,
                                   "reckoned": reckoned, "booked": booked,
                                   "n": len(named)}

    # the trainer under both flags, uncrashed and crashed after step 1's
    # checkpoint
    data = DataConfig(vocab=smollm_cfg.vocab, seq_len=16, global_batch=4)
    ts = TrainStepConfig(grad_compress=True)
    perf.set_flags(microbatch=2)
    trained = {}
    for label in ("whole", "crashed"):
        crashed = []

        def hook(step):
            if label == "crashed" and step == 2 and not crashed:
                crashed.append(step)
                return "crash"
        tr = Trainer(smollm_cfg, data, TrainerConfig(
            total_steps=3, checkpoint_every=1,
            checkpoint_dir=f"{sys.argv[4]}/{label}", log_every=100), ts,
            device="cpu", fault_hook=hook, mesh=mesh)
        state = tr.run()
        trained[label] = state
        out[f"trainer/{label}"] = {
            "losses": [[h.step, h.loss] for h in tr.history],
            "restarts": tr.restarts,
            "ef_placed": all(tuple(state["ef"][n].placements)
                             == tuple(p.placements)
                             for n, p in state["params"].items())}
    perf.set_flags(microbatch=1)
    ef_diff = max(float((trained["whole"]["ef"][n].full_tensor()
                         - trained["crashed"]["ef"][n].full_tensor())
                        .abs().max()) for n in trained["whole"]["ef"])
    out["trainer/ef_diff"] = ef_diff
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
""")


def _ref_tree(arch: str, cfg=None) -> dict:
    """The reference's initial weights (key 0) of ``arch``'s reduced
    config as numpy arrays."""
    import jax
    from repro.configs import get_arch as jget
    from repro.models import build as jbuild
    from repro.models import unbox
    return jax.tree.map(np.asarray, unbox(jbuild(
        cfg or jget(arch).reduced()).init(jax.random.key(0))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 gloo processes' reports (:data:`GLOO`), every rank's, and
    the job they ran."""
    import dataclasses

    from repro.configs import get_arch as jget
    tmp = tmp_path_factory.mktemp("mesh_step")
    smollm = get_arch(SMOLLM).reduced()
    granite = _granite_cfg()
    jgranite = jget(GRANITE).reduced()
    jgranite = jgranite.replace(moe=dataclasses.replace(
        jgranite.moe, capacity_factor=8.0))
    job = {"smollm": (smollm, _ref_tree(SMOLLM), _tokens(smollm.vocab)),
           "odd": _tokens(smollm.vocab, ODD_ROWS, seed=2),
           "granite": (granite, _ref_tree(GRANITE, jgranite),
                       _tokens(granite.vocab)),
           "cases": {k: (kw, mb) for k, (_, kw, mb) in CASES.items()},
           "compress": {a: get_arch(a).reduced() for a in (SMOLLM, H2O)}}
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO, str(r), port, str(tmp),
         str(tmp / "ckpt")], env=_env(OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    reps = [_last_json(o) for o, _ in outs]
    return {"reps": reps, "job": job, "tmp": tmp}


def _same_on_every_rank(runs, key):
    reps = runs["reps"]
    assert all(r[key] == reps[0][key] for r in reps), key
    return reps[0][key]


def _one_process(cfg, tree, tokens, mb: int, n: int = 2, **ts_kw):
    """The port's one-process steps under ``microbatch=mb``."""
    ts = TrainStepConfig(**ts_kw)
    state = train_state_from_model(cfg, params_from_numpy(
        cfg, tree, device="cpu"), ts)
    with _microbatch(mb):
        step = make_train_step(cfg, "cpu", ts)
        rows = []
        for _ in range(n):
            state, m = step(state, {"tokens": torch.as_tensor(tokens)})
            rows.append({k: float(v) for k, v in m.items()})
    return rows


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_the_one_process_step(runs, case):
    """Two sharded steps of reduced smollm (B 4, S 16) on the (2, 2) gloo
    mesh under each case's flags, against the port's one-process step
    under the same flags (``zero1`` is the plain step there): every rank
    reports the same numbers; the losses within rel 2e-4 (the
    reference's own microbatch rule, ``tests/test_torch_perf.py``), the
    first within 2e-5 (before any update the mesh's forward is the one
    process's bit for bit), each gradient norm within rel 1e-3.  Under
    ``grad_compress`` the codes are formed on the reduced gradients,
    which differ from the one process's in the last bits, so a code at
    a rounding tie may step once: the second loss and the norms carry
    that."""
    arch, ts_kw, mb = CASES[case]
    got = _same_on_every_rank(runs, case)
    cfg, tree, tok = runs["job"]["smollm"]
    ts_kw = {k: v for k, v in ts_kw.items() if k != "zero1"}
    want = _one_process(cfg, tree, tok, mb, **ts_kw)
    print(f"\n{case}: losses {[g['loss'] for g in got]} against "
          f"{[w['loss'] for w in want]}, norms "
          f"{[g['grad_norm'] for g in got]} against "
          f"{[w['grad_norm'] for w in want]}")
    assert got[0]["loss"] == pytest.approx(want[0]["loss"], rel=2e-5)
    assert got[1]["loss"] == pytest.approx(want[1]["loss"], rel=2e-4)
    for g, w in zip(got, want):
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-3)
        assert set(g) == set(w)
    if ts_kw.get("grad_compress"):
        assert _same_on_every_rank(runs, case + "/ef_placed") is True


def test_microbatches_of_a_dtensor_batch_are_the_global_arrays(runs):
    """The batch handed to the step as a DTensor over ``data`` (as the
    dry run hands it) is routed into its microbatches by all-to-all:
    the steps equal those of the same batch as a global array, which
    each rank cuts before distributing, bit for bit; and the routing
    on a (2, 2) mesh and on a (pod 2, data 2, model 1) mesh (two batch
    axes, one all-to-all each) gives microbatch i the global rows [i
    B / mb, (i + 1) B / mb) over the batch axes, at mb 2 and 4."""
    assert _same_on_every_rank(runs, "mb2_dtensor") == \
        _same_on_every_rank(runs, "mb2")
    assert _same_on_every_rank(runs, "routed") == {
        "2/2": True, "2/4": True, "3/2": True, "3/4": True}


def test_microbatched_step_differs_from_the_plain_one(runs):
    """``microbatch=2`` is not the plain step: its loss is the mean of
    two microbatches' losses, which rounds otherwise than the mean over
    the batch, and its update follows."""
    assert _same_on_every_rank(runs, "mb2") != \
        _same_on_every_rank(runs, "mb1")


def test_ragged_microbatch_raises_and_odd_batch_runs_plain(runs):
    """A microbatch of 1 row over the 2 data ranks (B 4 at
    ``microbatch=4``) raises ``ValueError`` naming the rows and the
    ranks, where the reference pads the uneven shard (ROADMAP queue 3);
    a batch of 6 rows, which 4 does not divide, runs the plain step as
    in the reference, bit for bit."""
    msg = _same_on_every_rank(runs, "ragged")
    assert msg is not None and "1 of the batch's 4 rows" in msg \
        and "2 devices" in msg, msg
    assert _same_on_every_rank(runs, "odd_mb4") == \
        _same_on_every_rank(runs, "odd_mb1")


def test_granite_aux_loss_is_per_microbatch_on_a_mesh(runs, monkeypatch):
    """Reduced granite (capacity factor 8: no pick dropped) on the gloo
    mesh at ``microbatch=2`` against the port's one-process step at 2,
    its experts in float32 as the mesh path computes them
    (``test_torch_moe_mesh._float32_route``): the first step's loss, ce
    and aux within rel 2e-4 of the one process's; the ce within rel 2e-4
    of the mesh's own at ``microbatch=1`` (a mean over tokens), and the
    aux, the mean of the microbatches' own router losses, not equal to
    it."""
    from test_torch_moe_mesh import _float32_route
    _float32_route(monkeypatch)
    two = _same_on_every_rank(runs, "granite/mb2")[0]
    one = _same_on_every_rank(runs, "granite/mb1")[0]
    cfg, tree, tok = runs["job"]["granite"]
    want = _one_process(cfg, tree, tok, 2, n=1)[0]
    print(f"\ngranite mb 2: {two}\n  one process: {want}\n  mb 1: {one}")
    for key in ("loss", "ce", "aux"):
        assert two[key] == pytest.approx(want[key], rel=2e-4), key
    assert two["ce"] == pytest.approx(one["ce"], rel=2e-4)
    assert two["aux"] != one["aux"]


@pytest.mark.parametrize("arch", (SMOLLM, H2O, "extra"))
def test_ef_compress_on_dtensors_is_the_global_compress(runs, arch):
    """``ef_compress_grads`` on seeded float32 gradients and errors at
    each parameter's placements of reduced smollm's and h2o-danube's
    specs on the (2, 2) mesh, and at four placements of the ``extra``
    case (a leaf sharded on both dims over both axes; a first dim cut
    into whole 256-blocks; a first dim cut into 15 elements; a second
    dim cut): the gradient and error it returns, at the same placements,
    equal the one-process compress of the global tensors bit for bit;
    the leaves it gathers (``gather_bytes``: a block that is not whole
    256-blocks of the flat order in one run: the heads' and the ff
    dim's column cuts, h2o's untied head) moved exactly the reckoned
    bytes, booked under ``compress``, and the rest none."""
    rep = _same_on_every_rank(runs, f"compress/{arch}")
    print(f"\n{arch}: {rep['n']} leaves, gathered {rep['gathered']}, "
          f"{rep['booked']} B")
    assert rep["equal"] is True
    assert rep["gathered"] and len(rep["gathered"]) < rep["n"]
    assert rep["booked"] == rep["reckoned"] > 0
    if arch == "extra":
        assert rep["gathered"] == ["two_dims", "rows", "cols"]


def test_compresses_in_place_rule():
    """The in-place rule on a fake (2, 2) world: replicated leaves; a
    leaf sharded on its first non-unit dim with whole 256-blocks a
    device; not a dim after a non-unit one, two sharded dims, an uneven
    cut, or a block of 128 elements."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.optim import compresses_in_place, gather_bytes
    R, S0, S1 = Replicate(), Shard(0), Shard(1)
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        assert compresses_in_place((5, 3), (R, R), mesh)
        assert compresses_in_place((512, 3), (R, S0), mesh)
        assert compresses_in_place((1, 512, 4), (S1, R), mesh)
        assert compresses_in_place((1024,), (S0, S0), mesh)
        assert not compresses_in_place((6, 200), (R, S1), mesh)
        assert not compresses_in_place((6, 5), (S0, R), mesh)
        assert not compresses_in_place((256,), (S0, R), mesh)
        assert not compresses_in_place((512, 512), (S0, S1), mesh)
        assert gather_bytes((512, 512), (S0, R), mesh) == []
        assert gather_bytes((6, 200), (R, S1), mesh) == [6 * 200 * 4]
        assert gather_bytes((512, 512), (S0, S1), mesh) == [
            256 * 512 * 4, 512 * 512 * 4]


def test_trainer_on_a_mesh_under_both_flags(runs):
    """The trainer on the gloo mesh with ``grad_compress`` and
    ``microbatch=2`` (reduced smollm, B 4, S 16, a checkpoint every
    step) takes its three steps; a run crashed before step 2, after its
    checkpoint, resumes from it (one restart) and its step 2 loss is the
    uncrashed run's at rtol 1e-4 (the reference's own rule); ``ef``,
    restored through ``reshard_state`` at its specs, sits at the
    parameters' placements and equals the uncrashed run's bit for bit
    after step 2; the losses are the one-process trainer's under the
    steps' rules."""
    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer, TrainerConfig
    whole = _same_on_every_rank(runs, "trainer/whole")
    crashed = _same_on_every_rank(runs, "trainer/crashed")
    assert [s for s, _ in whole["losses"]] == [0, 1, 2]
    assert [s for s, _ in crashed["losses"]] == [0, 1, 2]
    assert whole["restarts"] == 0 and crashed["restarts"] == 1
    assert crashed["losses"][-1][1] == pytest.approx(
        whole["losses"][-1][1], rel=1e-4)
    assert whole["ef_placed"] and crashed["ef_placed"]
    assert _same_on_every_rank(runs, "trainer/ef_diff") == 0.0
    cfg = runs["job"]["smollm"][0]
    with _microbatch(2):
        one = Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=16,
                                      global_batch=4),
                      TrainerConfig(total_steps=3, checkpoint_every=10,
                                    checkpoint_dir=str(runs["tmp"] / "one"),
                                    log_every=100),
                      TrainStepConfig(grad_compress=True), device="cpu")
        one.run()
    for (step, loss), h in zip(whole["losses"], one.history):
        assert loss == pytest.approx(h.loss, rel=2e-5 if step == 0
                                     else 2e-4)


def _dry_cell(mb: int) -> dict:
    with _microbatch(mb):
        return dryrun.lower_cell(SMOLLM, "t", False, "cpu",
                                 cfg=get_arch(SMOLLM).reduced(), shape=SMALL)


def test_microbatched_dry_run_keeps_the_gradient_bytes():
    """Reduced smollm's cell on a fake (16, 16) world at ``microbatch=2``
    against 1: the data-parallel gradient all-reduce is exactly
    ``SMOLLM_DP_BYTES`` in both (one reduction a step); the microbatches'
    re-placement sits in its own phase, ``split`` over ``data`` (an
    all-to-all of the local 2 rows of 256 int32 tokens); every loss-phase
    collective appears twice as often at half its rows; the record
    holds the microbatch's rows and count and the accumulator's bytes
    (the local parameters' bytes)."""
    one, two = _dry_cell(1), _dry_cell(2)
    assert one["dp_gradient_bytes"] == two["dp_gradient_bytes"] == {
        "all-reduce": SMOLLM_DP_BYTES}
    pa, pb = (r["collective_bytes_by_phase_axis"] for r in (one, two))
    assert pb.pop("split/data") == {"all-to-all": 2 * 256 * 4}
    assert "split/data" not in pa
    for key in ("gradients/data", "gradients/model", "optimizer/model",
                "loss/model"):
        assert pa[key] == pb[key], key
    assert pb["loss/data"] == {"all-reduce": 2 * pa["loss/data"]
                               ["all-reduce"]}
    rows_a = sorted((r["kind"], r["bytes"] // 2, 2 * r["count"])
                    for r in one["collectives"] if r["at"] == "loss/model")
    rows_b = sorted((r["kind"], r["bytes"], r["count"])
                    for r in two["collectives"] if r["at"] == "loss/model")
    assert rows_b == rows_a
    assert one["per_device_batch"] == [2, 256] and one["microbatch"] == 1
    assert two["per_device_batch"] == [1, 256] and two["microbatch"] == 2
    parts = two["memory"]["peak_parts"]
    assert parts["logits_and_gradient"] == \
        one["memory"]["peak_parts"]["logits_and_gradient"] // 2
    assert parts["gradient_accumulator"] > 0


REF_SHARDED = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["REPRO_PERF"] = "microbatch=2"
    import json, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_arch
    from repro.train.train_step import (TrainStepConfig, init_train_state,
                                        make_train_step)

    with open(sys.argv[1], "rb") as f:
        tok = pickle.load(f)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    cfg = get_arch("smollm-135m").reduced()
    out = {}
    for key, gc in (("mb2", False), ("gc_mb2", True)):
        ts = TrainStepConfig(grad_compress=gc)
        with mesh:
            step, _ = make_train_step(cfg, mesh, ts, donate=False)
            state = init_train_state(cfg, jax.random.key(0), ts)
            rows = []
            for _ in range(2):
                state, m = step(state, {"tokens": jnp.asarray(
                    tok.astype(np.int32))})
                rows.append([float(m["loss"]), float(m["grad_norm"])])
        out[key] = rows
    print(json.dumps(out))
""")


@pytest.mark.slow
def test_microbatched_sharded_step_matches_the_reference(runs, tmp_path):
    """The sharded steps at ``microbatch=2``, with and without
    ``grad_compress``, against the reference's (its ``make_train_step``
    on a (2, 2) Auto-axis mesh of 4 host devices under
    ``REPRO_PERF=microbatch=2``, from the same weights on the same
    batch) at the limits of the plain sharded step's comparison
    (``tests/test_torch_dryrun.py``): each loss within 1e-3, each
    gradient norm within rel 3e-2."""
    with open(tmp_path / "tok.pkl", "wb") as f:
        pickle.dump(runs["job"]["smollm"][2], f)
    out = subprocess.run([sys.executable, "-c", REF_SHARDED,
                          str(tmp_path / "tok.pkl")], env=_env(),
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = _last_json(out.stdout)
    for key in ("mb2", "gc_mb2"):
        for got, (jloss, jnorm) in zip(runs["reps"][0][key], ref[key]):
            print(f"\n{key}: loss {got['loss']} / {jloss}, norm "
                  f"{got['grad_norm']} / {jnorm}")
            assert abs(got["loss"] - jloss) < 1e-3, key
            assert got["grad_norm"] == pytest.approx(jnorm, rel=3e-2), key


def test_dry_run_refills_unwritten_microbatches():
    """``dryrun._refill``, the dry run's ``AFTER_SPLIT`` hook: a fake
    group may leave the split's all-to-all output unwritten, so the
    microbatches' tokens are taken into the vocabulary and their memory
    made finite within [-1, 1], in place on the local blocks."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    tok = torch.tensor([[-5, 3, 700, 2**30]] * 4)
    mem = torch.tensor([float("nan"), float("inf"), -3.0, 0.5]).repeat(
        4, 1, 1).bfloat16()
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        pl = (Shard(0), Replicate())
        parts = [{"tokens": distribute_tensor(tok, mesh, pl,
                                              src_data_rank=None),
                  "memory": distribute_tensor(mem, mesh, pl,
                                              src_data_rank=None)}]
        dryrun._refill(parts, 512)
        got_t = parts[0]["tokens"].to_local()
        got_m = parts[0]["memory"].to_local().float()
    assert got_t.tolist() == [[507, 3, 188, 2**30 % 512]] * 2
    assert got_m[0, 0].tolist() == [0.0, 0.0, -1.0, 0.5]


def test_launcher_builds_the_compressed_step_on_the_production_mesh(
        tmp_path):
    """``launch.train --production-mesh --grad-compress``: with no process
    group it raises, naming the dry run; on a fake world of 256 ranks it
    builds the sharded step and takes a step of reduced smollm (16 rows,
    one a data rank), its ``ef`` at the parameters' placements (the fake
    group carries no value, so only the layout is read)."""
    from repro_torch.launch.train import train
    kw = dict(reduced=True, steps=1, seq=16, batch=16, device="cpu",
              grad_compress=True, production_mesh=True,
              ckpt_dir=str(tmp_path), ckpt_every=100)
    with pytest.raises(RuntimeError, match="dryrun"):
        train(SMOLLM, **kw)
    with dryrun.fake_world(256):
        trainer, state = train(SMOLLM, **kw)
        assert [h.step for h in trainer.history] == [0]
        assert all(tuple(state["ef"][n].placements) == tuple(p.placements)
                   for n, p in state["params"].items())
