"""The training slice of repro_torch against the reference: loss and
gradients, one train step, the data pipeline, checkpoints, the trainer
(crash and resume, stragglers) and the launcher, on reduced smollm-135m
(2 layers, d_model 128, 4 q heads over 2 kv heads of 32, vocab 512).

The reference's weights (``unbox(bundle.init(key))`` as numpy arrays)
go into the port through ``convert.params_from_numpy``; gradients and
updated weights come back through ``convert.params_to_numpy``.  The
port runs on the CPU, where its kernels' plain versions stand in for
the CUDA kernels.

Tolerances.  Activations are bf16 on both sides, rounded at different
places.  The loss within 1e-3 absolute (measured 1.2e-4; ln 512 =
6.24).  Each gradient leaf within 3e-2 of its largest magnitude, the
reference's bf16 tolerance (measured up to 1.4e-2; the reference's own
``jnp`` and ``pallas_interpret`` paths differ by up to 8.8e-3), and the
whole gradient at cosine similarity >= 0.9999.  After one AdamW step
(the first step moves each weight by lr * (sign(g) + wd * w)), weights
whose gradient is clear of that noise (|g| > 0.1 of the leaf's largest)
agree within 1e-6; the others differ by at most 2 lr.  The data
pipeline is compared bit for bit; the trainer's resumed loss at rtol
1e-4, as the reference's own test.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import DataConfig, host_shard_batch, synthetic_batch
from repro_torch.models import build, forward, loss_fn
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.train import (CheckpointManager, TrainStepConfig, Trainer,
                               TrainerConfig, latest_step, make_train_step,
                               restore_checkpoint, save_checkpoint,
                               train_state_from_model)

LR = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU products: torch's thread pool only adds latency here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_arch("smollm-135m").reduced()


@functools.cache
def _reference(seed: int = 0):
    """(reference cfg, params, numpy params)."""
    import jax
    from repro.configs import get_arch as jget
    from repro.models import build as jbuild
    from repro.models import unbox
    cfg = jget("smollm-135m").reduced()
    params = unbox(jbuild(cfg).init(jax.random.key(seed)))
    return cfg, params, jax.tree.map(np.asarray, params)


def _tokens(b=2, s=64, seed=0):
    return np.random.default_rng(seed).integers(
        0, _cfg().vocab, (b, s)).astype(np.int32)


def _leaves(tree, prefix=""):
    """``{path: array}`` of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _port_grads(model, tokens):
    loss, metrics = loss_fn(model.cfg, model,
                            {"tokens": torch.from_numpy(tokens)})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return loss.detach(), metrics, dict(zip(names, grads))


def _close_grads(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    dot = ng = nw = 0.0
    for key in want:
        g, w = got[key], want[key]
        assert g.shape == w.shape, key
        scale = np.abs(w).max()
        assert scale > 0, key
        np.testing.assert_allclose(g, w, atol=3e-2 * scale, rtol=0,
                                   err_msg=f"{what} {key}")
        dot += float((g.astype(np.float64) * w).sum())
        ng += float((g.astype(np.float64) ** 2).sum())
        nw += float((w.astype(np.float64) ** 2).sum())
    assert dot / np.sqrt(ng * nw) >= 0.9999, what


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
def test_loss_and_grads_match_reference(impl):
    import jax
    import jax.numpy as jnp
    from repro.models.model import loss_fn as jloss
    jcfg, params, npp = _reference()
    tok = _tokens()
    f = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jcfg, p, b, impl=impl), has_aux=True))
    (jl, jm), jg = f(params, {"tokens": jnp.asarray(tok)})
    model = params_from_numpy(_cfg(), npp, device="cpu")
    loss, metrics, grads = _port_grads(model, tok)
    assert abs(float(loss) - float(jl)) < 1e-3
    assert abs(float(metrics["ce"]) - float(jm["ce"])) < 1e-3
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    _close_grads(_leaves(params_to_numpy(_cfg(), grads)),
                 _leaves(jax.tree.map(np.asarray, jg)), impl)


def test_every_weight_gets_a_gradient_and_remat_changes_nothing():
    """Gradients reach every float32 weight through the bf16 casts, and
    activation checkpointing recomputes exactly what it dropped."""
    cfg = _cfg()
    assert cfg.remat
    tok = _tokens(seed=1)
    model = build(cfg).init(3, device="cpu")
    loss, _, grads = _port_grads(model, tok)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
    plain = params_from_numpy(cfg.replace(remat=False),
                              params_to_numpy(cfg, model), device="cpu")
    loss2, _, grads2 = _port_grads(plain, tok)
    assert float(loss) == float(loss2)
    for name in grads:
        torch.testing.assert_close(grads[name], grads2[name], atol=0, rtol=0)


def test_loss_is_next_token_cross_entropy():
    """The loss against a direct float32 computation from the logits."""
    cfg = _cfg()
    model = build(cfg).init(1, device="cpu")
    tok = torch.from_numpy(_tokens(seed=2))
    with torch.no_grad():
        loss, metrics = loss_fn(cfg, model, {"tokens": tok})
        logits = forward(model, tok, mode="train")["logits"]
    logp = torch.log_softmax(logits[:, :-1].double(), -1)
    want = -logp.gather(-1, tok[:, 1:, None].long()).mean()
    assert float(loss) == pytest.approx(float(want), abs=1e-5)
    assert float(metrics["ce"]) == float(loss)
    assert abs(float(loss) - np.log(cfg.vocab)) < 0.5


def test_train_step_matches_reference_step():
    """One full step (loss, gradients, clipping, AdamW with the cosine
    schedule) against the reference's make_train_step on a (1, 1) host
    mesh."""
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import make_host_mesh
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import cosine_schedule as jcos
    from repro.train import TrainStepConfig as JTS
    from repro.train import init_train_state as jinit
    from repro.train import make_train_step as jmake
    jcfg, _, npp = _reference()
    tok = _tokens(seed=3)
    jts = JTS(optimizer=JAdamW(lr=jcos(LR, warmup=2, total=10)))
    jstate = jinit(jcfg, jax.random.key(0), jts)
    np.testing.assert_array_equal(
        np.asarray(jstate["params"]["embed"]), npp["embed"])
    jstep, _ = jmake(jcfg, make_host_mesh(1, 1), jts)
    jnew, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
    jg = _leaves(jax.tree.map(np.asarray, jnew["params"]))

    cfg = _cfg()
    ts = TrainStepConfig(optimizer=AdamWConfig(lr=cosine_schedule(
        LR, warmup=2, total=10)))
    state = train_state_from_model(
        cfg, params_from_numpy(cfg, npp, device="cpu"), ts)
    old = {k: v.clone() for k, v in state["params"].items()}
    step_fn = make_train_step(cfg, "cpu", ts, donate=False)
    new, m = step_fn(state, {"tokens": torch.from_numpy(tok)})
    for k, v in state["params"].items():          # the old state stays
        assert torch.equal(v, old[k])
    assert int(new["step"]) == int(jnew["step"]) == 1
    assert int(new["opt"]["count"]) == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-3
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=3e-2)
    _, _, grads = _port_grads(params_from_numpy(cfg, npp, device="cpu"), tok)
    gmag = _leaves(params_to_numpy(cfg, grads))
    got = _leaves(params_to_numpy(cfg, new["params"]))
    p0 = _leaves(npp)
    for key in jg:
        clear = np.abs(gmag[key]) > 0.1 * np.abs(gmag[key]).max()
        assert clear.any(), key
        np.testing.assert_allclose(got[key][clear], jg[key][clear],
                                   atol=1e-6, rtol=0, err_msg=key)
        assert np.abs(got[key] - jg[key]).max() <= 2 * LR + 1e-6, key
        assert np.abs(got[key] - p0[key]).max() > 0, key


def test_grad_compress_step_runs_and_carries_errors():
    cfg = _cfg()
    ts = TrainStepConfig(grad_compress=True)
    state = train_state_from_model(cfg, build(cfg).init(0, "cpu"), ts)
    step_fn = make_train_step(cfg, "cpu", ts)
    for i in range(2):
        state, m = step_fn(state, {"tokens": torch.from_numpy(
            _tokens(seed=10 + i))})
        assert np.isfinite(float(m["loss"]))
    assert any(float(e.abs().max()) > 0 for e in state["ef"].values())
    with pytest.raises(NotImplementedError, match="zero1"):
        make_train_step(cfg, "cpu", TrainStepConfig(zero1=True))


def test_mamba2_reduced_trains_on_cpu(tmp_path):
    """mamba2 trains through the SSD's backward: ``forward(mode="train")``
    returns no cache, every weight gets a finite gradient, the loss falls
    over a few steps, and the launcher trains it and resumes from its
    checkpoint (the first resumed step repeats the first run's loss)."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch.train import main
    cfg = get_arch("mamba2-130m").reduced()
    model = build(cfg).init(0, device="cpu")
    tok = torch.from_numpy(_tokens(b=2, s=48))
    out = forward(model, tok, mode="train")
    assert "cache" not in out and out["logits"].shape == (2, 48, cfg.vocab)
    loss, _ = loss_fn(cfg, model, {"tokens": tok})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
    assert SS.LAUNCHES == {"ssd_scan": 0, "ssd_scan_bwd": 0}
    args = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
            "--seq", "48", "--batch", "2", "--lr", "3e-3", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "4"]
    trainer, state = main(args + ["--steps", "6"])
    losses = [h.loss for h in trainer.history]
    assert trainer.cfg == cfg and len(losses) == 6
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert latest_step(str(tmp_path)) == 4
    trainer, state = main(args + ["--steps", "8"])
    assert [h.step for h in trainer.history] == [4, 5, 6, 7]
    # the resumed step 4 runs on the checkpoint's weights and batch (the
    # schedule's length differs from here on)
    assert trainer.history[0].loss == pytest.approx(losses[4], rel=1e-6)
    assert int(state["step"]) == 8


# ---------------------------------------------------------------------------
# Data, checkpoints, trainer, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed,memory", [
    (1000, 32, 8, 3, 0), (49152, 2048, 2, 0, 0), (512, 33, 4, 7, 5)])
def test_data_pipeline_is_the_references(vocab, seq, batch, seed, memory):
    from repro.data import DataConfig as JData
    from repro.data import host_shard_batch as jshard
    from repro.data import synthetic_batch as jbatch
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed,
              memory_tokens=memory, d_model=8 if memory else 0)
    mine, theirs = DataConfig(**kw), JData(**kw)
    for step in (0, 5, 123456):
        a, b = synthetic_batch(mine, step), jbatch(theirs, step)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
        for h in range(2):
            np.testing.assert_array_equal(
                host_shard_batch(mine, step, h, 2)["tokens"],
                jshard(theirs, step, h, 2)["tokens"])


def _ckpt_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "h": torch.randn(5, generator=g).bfloat16()},
            "opt": {"m": {"w": torch.randn(3, 4, generator=g).bfloat16()},
                    "count": torch.tensor(7, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32),
            "host": np.arange(6.0).reshape(2, 3)}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return np.zeros_like(tree)


def _assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        np.testing.assert_array_equal(got, want)


def test_checkpoint_roundtrip_bf16_and_atomicity(tmp_path):
    d = str(tmp_path)
    state = _ckpt_state()
    save_checkpoint(d, 7, state, n_shards=2)
    later = _ckpt_state(1)
    save_checkpoint(d, 9, later, n_shards=1, extra_meta={"arch": "x"})
    # a save cut short leaves a .tmp directory and never a manifest
    os.makedirs(os.path.join(d, "step_00000011.tmp"))
    os.makedirs(os.path.join(d, "step_00000012"))
    assert latest_step(d) == 9
    restored, manifest = restore_checkpoint(d, _zeros_like(state))
    _assert_same(restored, later)       # bf16 bits back exactly
    assert manifest["step"] == 9 and manifest["arch"] == "x"
    assert "bfloat16" in manifest["dtypes"]
    restored7, _ = restore_checkpoint(d, _zeros_like(state), step=7)
    _assert_same(restored7, state)
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(d, {"params": {"w": torch.zeros(3, 4)}})
    bad = _zeros_like(state)
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, bad)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), state)


def test_checkpoint_manager_async_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    states = [_ckpt_state(i) for i in range(4)]
    for i, st in enumerate(states):
        mgr.save_async(i + 1, st)
    mgr.join()
    steps = sorted(p.name for p in tmp_path.iterdir())
    assert steps == ["step_00000003", "step_00000004"]
    restored, _ = restore_checkpoint(str(tmp_path), _zeros_like(states[0]))
    _assert_same(restored, states[3])


def test_checkpoint_manager_raises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker))
    mgr.save_async(1, _ckpt_state())
    with pytest.raises(OSError):
        mgr.join()
    mgr.join()                          # raised once


def _trainer(tmp, **kw):
    cfg = _cfg()
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    tcfg = TrainerConfig(total_steps=10, checkpoint_dir=str(tmp),
                         log_every=100, **kw)
    return cfg, data, tcfg


def test_trainer_crash_resume_matches_uncrashed_run(tmp_path):
    """Killed at step 7, the trainer resumes from the step-5 checkpoint
    and replays; its step-9 loss equals an uncrashed run's."""
    crashed = {"done": False}

    def fault(step):
        if step == 7 and not crashed["done"]:
            crashed["done"] = True
            return "crash"
        return None

    cfg, data, tcfg = _trainer(tmp_path / "a", checkpoint_every=5)
    tr = Trainer(cfg, data, tcfg, device="cpu", fault_hook=fault)
    state = tr.run()
    assert crashed["done"] and tr.restarts == 1
    assert int(state["step"]) == 10
    assert [s.step for s in tr.history] == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8,
                                            9]
    cfg, data, tcfg = _trainer(tmp_path / "b", checkpoint_every=5)
    tr2 = Trainer(cfg, data, tcfg, device="cpu")
    tr2.run()
    l1 = [s.loss for s in tr.history if s.step == 9]
    l2 = [s.loss for s in tr2.history if s.step == 9]
    np.testing.assert_allclose(l1, l2, rtol=1e-4)
    assert tr2.history[-1].loss < tr2.history[0].loss
    assert latest_step(str(tmp_path / "b")) == 10


def test_straggler_detection(tmp_path):
    def fault(step):
        if step == 8:
            time.sleep(1.0)  # a stall before the step
        return None

    cfg, data, tcfg = _trainer(tmp_path, checkpoint_every=100,
                               straggler_factor=3.0)
    tr = Trainer(cfg, data, tcfg, device="cpu", fault_hook=fault)
    tr.run()
    assert 8 in tr.straggler_steps, tr.straggler_steps
    assert tr.history[8].straggler


def test_launcher_trains_on_cpu_and_resumes(tmp_path):
    from repro_torch.launch.train import main
    args = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--seq", "32", "--batch", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    trainer, state = main(args + ["--steps", "3"])
    assert int(state["step"]) == 3 and len(trainer.history) == 3
    assert all(np.isfinite(h.loss) for h in trainer.history)
    assert trainer.device.type == "cpu"
    assert latest_step(str(tmp_path)) == 2
    trainer, state = main(args + ["--steps", "4"])
    assert [h.step for h in trainer.history] == [2, 3]
    assert int(state["step"]) == 4


@pytest.mark.parametrize("flags,reduced", [([], False), (["--full"], False),
                                           (["--reduced"], True)],
                         ids=["default", "full", "reduced"])
def test_launcher_trains_the_published_config_by_default(flags, reduced,
                                                         monkeypatch):
    """As the reference's launcher: no size flag trains the published
    config, ``--reduced`` its ``reduced()`` variant, ``--full`` names the
    default.  The trainer is stopped as it is built."""
    from repro_torch.launch import train as launch

    class Built(Exception):
        pass

    seen = []

    def trainer(cfg, *args, **kwargs):
        seen.append(cfg)
        raise Built

    monkeypatch.setattr(launch, "Trainer", trainer)
    with pytest.raises(Built):
        launch.main(["--arch", "mamba2-130m", "--device", "cpu"] + flags)
    want = get_arch("mamba2-130m")
    assert seen == [want.reduced() if reduced else want]


def test_trainer_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg, data, tcfg = _trainer(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, data, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg)
