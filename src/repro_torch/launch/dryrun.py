"""Production-mesh dry run on one card: rank 0's share of a train step,
a prefill or a decode step, run for real, with every collective counted
and none carried.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each (arch x shape x mesh) cell over 512 placeholder host
devices and reads the compiled program's costs.  The port opens a fake
process group of 256 (``pod1``) or 512 (``pod2``) ranks in this process,
builds the production mesh over it (:func:`~repro_torch.launch.mesh.
make_production_mesh`), places rank 0's blocks of the train state on the
card directly (``DTensor.from_local`` of seeded local values: the global
model is never built; granite-20b's float32 weights alone are 81 GB),
and runs one train step at the cell's per-device batch through the
kernels, with ``mesh``.  The fake group carries no data, so rank 0's
values are garbage after the first collective: the run measures shapes,
bytes, time and memory, never values.

  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k \\
      --mesh pod1
  python -m repro_torch.launch.dryrun --arch h2o-danube-3-4b \\
      --shape long_500k --device cpu
  python -m repro_torch.launch.dryrun --all --mesh pod1 --device cpu

The record has the reference's fields:

* ``collective_bytes_per_device``: every ``c10d_functional`` collective
  that the step issues, seen by a ``TorchDispatchMode``; each kind's
  per-device result bytes are added (the reference's ``collective_bytes``
  definition), plus ``total``.  ``collective_bytes_by_phase_axis``
  splits them by the step's part (``loss``: forward and backward;
  ``gradients``: the explicit data-parallel reduction; ``optimizer``: the
  clip's norm and ZeRO-1's all-gathers) and mesh axis, as
  ``"phase/axis"``; ``collectives`` lists each distinct collective
  (phase and axis, kind, result shape) with its bytes and count.  A MoE
  layer's all-to-all exchanges of its bins fall under ``loss/model``.
* ``flops``: rank 0's products: the aten ops counted by
  ``torch.utils.flop_counter``'s formulas on the local shapes, plus the
  hand-written kernels', which no dispatch mode sees, by the formulas of
  ``chip_smoke.py``'s bounds (:func:`kernel_flops`) on the local
  problems the mesh hooks handed them (``kernel_problems``: causal or
  not, a cross layer's Sq against the memory's Skv) times their
  launches in the step (an MLA problem at its own q/k and v heads;
  ``kernel_padding_flops``, the products the kernels add by padding
  them to the head they run, apart).  On the CPU nothing launches: the
  kernels' plain versions run as aten ops and are counted as such.
* ``memory``: ``argument_bytes`` the local state, ``peak_bytes`` the
  card's peak allocation in the step above what was allocated before
  it, ``temp_bytes`` that less the state; ``peak_parts`` splits the
  state and the peak into the state, the saved activations (the
  allocation at the end of the forward, less what was allocated before
  the step and one copy of the local float32 logits), the logits and
  their gradient (twice the local float32 logits' bytes, each head's:
  what the loss keeps for its backward and the gradient it hands back)
  and the rest (the peak less these); on the CPU only the state and the
  logits' part, which are counted, not measured.
* ``n_devices``, ``mesh``, ``perf_flags``, ``status``; keys with no
  counterpart in an eager run (``compile_seconds``, ``hlo_chars``,
  ``probe``, ``raw``, ``bytes_accessed``, ``transcendentals``,
  ``alias_bytes``, ``generated_code_bytes``) are null.  The port runs its
  layers unrolled, so every layer is counted once and there is no probe
  correction (``scan_reps`` is 0).

Every family runs its ``train_4k`` cell; a memory-input config's batch
carries its memory as the reference's ``input_specs`` give it (vision:
(B, n_image_tokens, d_model), an encoder: (B, seq // frame_ratio,
d_model), bf16 over the batch axes).

Every family also runs its serve cells (``prefill_32k``,
``decode_32k``, and ``long_500k`` where the config is sub-quadratic) as
the reference's ``_lower_prefill`` and ``_lower_decode`` lower them
(:func:`_serve_metrics`): the parameters of the train state without the
moments; a prefill of the cell's rows (a memory config's with a seeded
memory of :func:`memory_tokens` rows over the batch axes, as the
reference's ``_memory_abstract`` gives it), or one decode step of one
token a row at position ``seq_len - 1`` against rank 0's blocks of the
cache of a prefill into ``min(seq_len, window)`` slots
(:func:`local_cache`: placed by ``cache_specs``, seeded values, ``kpos``
exact; a memory config's cross layers and ``enc_memory`` at the
memory's length).  The collectives are booked under the phase
``prefill`` or ``decode``; the record has the train record's fields, its
``memory`` the arguments (the parameters, the memory in a prefill, the
cache in decode), the outputs (the local logits and the cache), the
peak and ``peak_parts`` (``params``, ``cache``, ``logits``, ``rest``:
the peak less the logits and the cache the step allocated; ``memory``,
the memory's local bytes, where the cell carries one), ``cache_parts``
the cache's local bytes by leaf name (:func:`cache_bytes`) and
``context`` the cache's slots.  ``long_500k`` on a full-attention arch
is skipped as in the reference.  :func:`run_cell`
writes each record as JSON under ``REPRO_DRYRUN_DIR`` (default
``build/dryrun/`` of the checkout).  :class:`~repro_torch.fabric.
planner.StepProfile`'s ``from_dryrun`` reads a record.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..configs import ARCHS, SHAPES, get_arch
from ..configs.base import ArchConfig, ShapeConfig

__all__ = ["OUT_DIR", "CollectiveCounter", "fake_world", "kernel_flops",
           "kernel_padding_flops", "memory_tokens",
           "dp_gradient_bytes", "local_params", "local_train_state",
           "local_cache", "cache_bytes", "reckon_cache_bytes",
           "decode_context", "lower_cell",
           "cell_path", "run_cell", "main"]

OUT_DIR = os.environ.get(
    "REPRO_DRYRUN_DIR",
    str(Path(__file__).resolve().parents[3] / "build" / "dryrun"))

# c10d_functional op -> the reference's collective kind
_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("permute", "collective-permute"))

# result dtypes as the reference's HLO writes them
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16", torch.int32: "s32", torch.int64: "s64"}

# the launch counters of each kernel family's kernels
_LAUNCH_KEYS = {"attention": ("flash_attention_fwd", "flash_attention_dq",
                              "flash_attention_dkv"),
                "ssd": ("ssd_scan", "ssd_scan_bwd")}
_LAUNCH_KEYS["mla"] = _LAUNCH_KEYS["attention"]


def _kind(op_name: str):
    if "c10d_functional" not in op_name:
        return None
    for key, kind in _KINDS:
        if key in op_name:
            return kind
    return None


class CollectiveCounter:
    """A dispatch mode that books every collective's per-device result
    bytes by kind, by the step's phase
    (:data:`repro_torch.train.train_step.COLLECTIVE_PHASE`) and mesh axis
    together, and by each distinct collective (:meth:`table`), and counts
    the products of the local aten ops with
    ``torch.utils.flop_counter``'s formulas.  DTensor ops are let
    through to DTensor (which then issues the local ops and collectives
    that are counted); fake tensors of its sharding propagation are not
    counted."""

    def __init__(self, mesh=None):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        self.bytes: dict[str, float] = {}
        self.collectives: dict[tuple, int] = {}
        self.by_phase_axis: dict[str, dict] = {}
        self.calls = 0
        self.flops = 0
        groups = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                groups[mesh.get_group(i).group_name] = name
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch._subclasses.fake_tensor import FakeTensor
                from torch.distributed.tensor import DTensor

                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if any(issubclass(t, FakeTensor) for t in types):
                    return out
                kind = _kind(str(func))
                if kind is not None:
                    counter._book(kind, out, args, groups)
                pkt = func._overloadpacket
                if pkt in flop_registry:
                    # a product's ``out_dtype`` overload (``bmm.dtype``)
                    # carries its dtype as a positional argument, which
                    # the formulas do not take
                    shapes = [a for a in args
                              if not isinstance(a, torch.dtype)]
                    counter.flops += int(flop_registry[pkt](
                        *shapes, **kwargs, out_val=out))
                return out

        self._mode = _Mode()

    def _book(self, kind, out, args, groups):
        from ..train.train_step import COLLECTIVE_PHASE

        outs = [t for t in (out if isinstance(out, (list, tuple)) else [out])
                if isinstance(t, torch.Tensor)]
        nbytes = sum(t.numel() * t.element_size() for t in outs)
        group = [a for a in args if isinstance(a, str)][-1:] or [None]
        axis = groups.get(group[0], "other")
        at = f"{COLLECTIVE_PHASE['name'] or 'other'}/{axis}"
        self.calls += 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes
        row = self.by_phase_axis.setdefault(at, {})
        row[kind] = row.get(kind, 0) + nbytes
        shape = ", ".join(f"{_DTYPE_NAMES.get(t.dtype, t.dtype)}"
                          f"[{','.join(map(str, t.shape))}]" for t in outs)
        key = (at, kind, shape, nbytes)
        self.collectives[key] = self.collectives.get(key, 0) + 1

    def table(self) -> list:
        """Each distinct collective (``"phase/axis"``, kind, result shape)
        with its bytes and count, the largest total first."""
        rows = [{"at": at, "kind": kind, "shape": shape, "bytes": nbytes,
                 "count": n}
                for (at, kind, shape, nbytes), n in self.collectives.items()]
        return sorted(rows, key=lambda r: -r["bytes"] * r["count"])

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def per_device(self) -> dict:
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        return out


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` ranks, this process rank 0, for
    the duration of the block: collectives return at once and carry
    nothing.  Raises where a process group is open already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is open already; the dry run "
                           "opens its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dp_gradient_bytes(by_phase_axis: dict) -> dict:
    """The data-parallel gradient reduction's bytes by kind: the
    ``gradients`` phase's collectives over the batch axes (``data``,
    ``pod``)."""
    out: dict[str, float] = {}
    for axis in ("pod", "data"):
        for kind, b in by_phase_axis.get(f"gradients/{axis}", {}).items():
            out[kind] = out.get(kind, 0) + b
    return out


# ---- the kernels' products (chip_smoke.py's bound formulas) ------------


def _live_pairs(s: int, window) -> int:
    """Causal (q, k) pairs of a length-s sequence, within ``window``."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _ssd_products(length: int, chunk: int, h: int, p: int, g: int, n: int):
    """(forward, backward) products of the SSD over one sequence: C B^T
    and the decayed scores times x dt over each chunk's lower triangle, C
    S_in and B^T (decay dt x) over the chunk; the backward's C B^T, dy
    x^T, (C B^T L)^T dy, (G L dt) B, (G L)^T C over the triangle and B
    dS, dy S_in^T, x dS^T, C^T (exp(cum) dy), B^T (x dt w) over the
    chunk."""
    fwd = bwd = 0.0
    for c0 in range(0, length, chunk):
        qc = min(chunk, length - c0)
        tri = qc * (qc + 1) / 2
        fwd += 2 * tri * n * g + 2 * tri * p * h + 4 * qc * n * p * h
        bwd += (2 * tri * (n * g + p * h) + 2 * tri * (p + 2 * n) * h
                + 5 * 2 * qc * n * p * h)
    return fwd, bwd


def _pairs(sq: int, skv: int, window, causal: bool) -> int:
    """The (q, k) pairs a problem attends: the live causal pairs within
    ``window`` (Sq = Skv), or every one of Sq x Skv (non-causal: the
    encoder's self-attention, a cross layer's Sq against the memory)."""
    if causal:
        if sq != skv:
            raise ValueError(f"causal {sq} x {skv}: a train step's causal "
                             f"problems are square")
        return _live_pairs(sq, window)
    if window is not None:
        raise ValueError("a non-causal problem with a window")
    return sq * skv


def _attention_products(b, h, pairs, dqk, dv) -> tuple:
    """Products of #5, #6 and #7 on one problem, Q K^T and dS K, dS^T Q
    at the q/k head ``dqk``, P.V, dO V^T and P^T dO at the value head
    ``dv``: (#5 Q K^T + P.V; #6 Q K^T + dO V^T + dS K; #7 Q K^T + dO V^T
    + P^T dO + dS^T Q), each product 2 D H B over the ``pairs``
    attended."""
    mm = 2.0 * h * b * pairs
    return (mm * (dqk + dv), mm * (2 * dqk + dv), mm * (2 * dqk + 2 * dv))


def _launch_shares(family: str, seen: dict, launches: dict) -> dict:
    """``{problem: launches of each of the family's kernels}``: the
    family's launches split over its local problems in proportion to
    their calls.  A train step makes every call of a family alike
    (forward and remat recompute, or forward alone, each with one
    backward), so the split is whole; where it is not, the launches
    cannot be apportioned and it raises."""
    total = sum(seen.values())
    out = {}
    for problem, calls in seen.items():
        row = []
        for key in _LAUNCH_KEYS[family]:
            n = launches.get(key, 0) * calls
            if n % total:
                raise ValueError(
                    f"{launches.get(key, 0)} {key} launches do not split "
                    f"over {len(seen)} local {family} problems of "
                    f"{sorted(seen.values())} calls")
            row.append(n // total)
        out[problem] = tuple(row)
    return out


def _problem_flops(family: str, problem: tuple, n: tuple):
    """(products, of them the head padding's) of one family's ``n``
    launches (its kernels' in :data:`_LAUNCH_KEYS` order) on one local
    problem (:func:`kernel_flops`)."""
    if family in ("attention", "mla"):
        if family == "attention":
            b, h, _, sq, skv, dqk, window, causal = problem
            dv = dqk
        else:
            b, h, sq, skv, dqk, dv = problem
            window, causal = None, True
        from ..kernels.flash_attention import _pad_head
        pairs = _pairs(sq, skv, window, causal)
        own = sum(c * f for c, f in zip(n, _attention_products(
            b, h, pairs, dqk, dv)))
        dp = _pad_head(max(dqk, dv))
        padded = sum(c * f for c, f in zip(n, _attention_products(
            b, h, pairs, dp, dp)))
        return own, padded - own
    if family == "ssd":
        b, length, h, p, g, n_state, chunk = problem
        fwd, bwd = _ssd_products(length, chunk, h, p, g, n_state)
        return b * (fwd * n[0] + bwd * n[1]), 0.0
    raise ValueError(f"no products for kernel family {family}")


def _flops(problems: dict, launches: dict) -> tuple:
    """(:func:`kernel_flops`, :func:`kernel_padding_flops`)."""
    if "attention" in problems and "mla" in problems:
        raise ValueError("attention and MLA problems in one step share "
                         "the kernels' launches")
    own = pad = 0.0
    for family, seen in problems.items():
        for problem, n in _launch_shares(family, seen, launches).items():
            o, p = _problem_flops(family, problem, n)
            own, pad = own + o, pad + p
    return own, pad


def kernel_padding_flops(problems: dict, launches: dict) -> float:
    """The products the attention kernels add by padding a head to the
    head they run (MLA's q/k 192 and v 128 to 256): the kernels do
    :func:`kernel_flops` plus these."""
    return _flops(problems, launches)[1]


def kernel_flops(problems: dict, launches: dict) -> float:
    """The products of the step's kernel launches on one device, from the
    local problems the mesh hooks handed the kernels (``problems``, as
    :func:`~repro_torch.models.layers.book_local_problems` books them)
    times each kernel's launches (``launches``: the kernels' ``LAUNCHES``
    keys): #5 Q K^T and P.V (2 mm, mm = 2 D Hq B pairs over the pairs
    attended: the live causal ones, or all Sq x Skv of a non-causal
    problem), #6 Q K^T, dO V^T and dS K (3 mm), #7 Q K^T, dO V^T, P^T dO
    and dS^T Q (4 mm); an MLA problem at its own heads, Q K^T, dS K and
    dS^T Q at q/k, the others at v (the padding to the kernels' head
    apart, :func:`kernel_padding_flops`); #8 and 8' by
    :func:`_ssd_products`.  A family's launches are split over its
    problems by their calls (:func:`_launch_shares`: a cross layer's,
    an encoder's and a self-attention's problems in one step); an
    attention and an MLA problem in one step raise, since they share
    the kernels' launches."""
    return _flops(problems, launches)[0]


# ---- rank 0's share of the state ----------------------------------------


def _local_init(name: str, shape, dtype, gen, device):
    """Seeded local values of a parameter block: ones for norm gains and
    the skip, zeros for biases and gates, a standard normal cut at +-2
    times 0.02 elsewhere (the values are not read as results)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("norm") or leaf == "d_skip":
        return torch.ones(shape, dtype=dtype, device=device)
    if leaf in ("conv_b", "dt_bias", "gate"):
        return torch.zeros(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(0.02).to(dtype)


def _from_local(local, mesh, spec, shape):
    from torch.distributed.tensor import DTensor

    from ..models.common import placements
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def local_params(cfg: ArchConfig, mesh, specs: dict, device,
                 seed: int = 0) -> dict:
    """Rank 0's blocks of the parameters as DTensors on ``mesh``, from a
    generator seeded with ``seed`` (:func:`_local_init`), each placed by
    ``specs`` (``{name: spec}``)."""
    from ..models.common import local_shape
    from ..models.model import param_shapes

    gen = torch.Generator(device=device).manual_seed(int(seed))
    return {name: _from_local(
        _local_init(name, local_shape(shape, specs[name], mesh), dt, gen,
                    device), mesh, specs[name], shape)
        for name, (shape, dt) in param_shapes(cfg).items()}


def local_train_state(cfg: ArchConfig, mesh, specs: dict, device,
                      seed: int = 0) -> dict:
    """Rank 0's blocks of a fresh train state as DTensors on ``mesh``:
    the parameters of :func:`local_params`, AdamW moments in the
    optimizer's dtype and ``count``/``step`` zero, each placed by
    ``specs`` (:func:`~repro_torch.train.train_step.
    make_train_state_specs`)."""
    from ..models.common import local_shape
    from ..models.model import param_shapes
    from ..train.train_step import TrainStepConfig, _opt_cfg

    state_dtype = _opt_cfg(cfg, TrainStepConfig()).state_dtype
    params = local_params(cfg, mesh, specs["params"], device, seed)
    m, v = {}, {}
    for name, (shape, dt) in param_shapes(cfg).items():
        for moments in (m, v):
            ms = specs["opt"]["m"][name]
            moments[name] = _from_local(torch.zeros(
                local_shape(shape, ms, mesh), dtype=state_dtype,
                device=device), mesh, ms, shape)
    zero = lambda: _from_local(torch.zeros((), dtype=torch.int32,
                                           device=device), mesh, (), ())
    return {"params": params, "opt": {"m": m, "v": v, "count": zero()},
            "step": zero()}


def _state_bytes(state) -> int:
    if isinstance(state, dict):
        return sum(_state_bytes(v) for v in state.values())
    return state.to_local().numel() * state.to_local().element_size()


def _skip_reason(cfg: ArchConfig, shape: ShapeConfig):
    if shape.kind == "decode" and shape.name == "long_500k" \
            and not cfg.sub_quadratic:
        return ("long_500k requires sub-quadratic attention "
                "(full-attention arch; see DESIGN.md)")
    return None


def memory_tokens(cfg: ArchConfig, seq_len: int) -> int:
    """The memory's length a row of a train batch: a vision config's
    image tokens, an encoder config's frames (seq // frame_ratio, at
    least 1), else 0 (the reference's ``input_specs``)."""
    if cfg.vision is not None:
        return cfg.vision.n_image_tokens
    if cfg.encoder is not None:
        return max(1, seq_len // cfg.encoder.frame_ratio)
    return 0


def _logits_bytes(cfg: ArchConfig, rows: int, seq_len: int, mesh) -> int:
    """The local float32 logits of a step, each head's (the MTP head's
    too): vocab-parallel over ``model`` where the vocabulary divides it,
    else whole on every device (the reference's ``_constrain_logits``)."""
    from ..models.common import axis_sizes
    mp = axis_sizes(mesh).get("model", 1)
    v = cfg.vocab // mp if cfg.vocab % mp == 0 else cfg.vocab
    return (2 if cfg.mtp else 1) * rows * seq_len * v * 4


def _step_metrics(cfg: ArchConfig, shape: ShapeConfig, mesh, device,
                  seed: int = 0) -> dict:
    """Run rank 0's share of one train step of ``shape`` on ``mesh`` and
    measure it (see the module's docstring)."""
    from ..data import DataConfig, synthetic_batch
    from ..kernels import flash_attention as FA
    from ..kernels import ssd_scan as SS
    from ..models.common import DEFAULT_RULES, axis_sizes
    from ..models.layers import book_local_problems
    from ..perf import flags
    from ..train.train_step import (AFTER_FORWARD, TrainStepConfig,
                                    batch_pspec, make_train_state_specs,
                                    make_train_step)

    rules = DEFAULT_RULES.replace(ff=None) if flags().replicate_ff \
        else DEFAULT_RULES
    ts = TrainStepConfig(zero1=flags().zero1, rules=rules)
    specs = make_train_state_specs(cfg, mesh, ts)
    state = local_train_state(cfg, mesh, specs, device, seed)
    sizes = axis_sizes(mesh)
    n_batch = int(np.prod([sizes[a] for a in (batch_pspec(mesh)[0] or ())]))
    rows = shape.global_batch // n_batch
    data = DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                      global_batch=shape.global_batch, seed=seed)
    local = torch.as_tensor(synthetic_batch(data, 0, slice(0, rows))
                            ["tokens"], device=device)
    batch = {"tokens": _from_local(local, mesh, batch_pspec(mesh),
                                   (shape.global_batch, shape.seq_len))}
    n_mem = memory_tokens(cfg, shape.seq_len)
    if n_mem:
        # the stub frontend's embeddings, made on the device (their
        # values are not read as results)
        gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
        batch["memory"] = _from_local(
            torch.randn((rows, n_mem, cfg.d_model), generator=gen,
                        device=device).to(torch.bfloat16), mesh,
            batch_pspec(mesh) + (None, None),
            (shape.global_batch, n_mem, cfg.d_model))
    step_fn = make_train_step(cfg, device, ts, donate=True, mesh=mesh)
    arg_bytes = _state_bytes(state)
    cuda = torch.device(device).type == "cuda"
    marks = []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        AFTER_FORWARD.append(lambda: marks.append(
            torch.cuda.memory_allocated()))
    FA.reset_launches()
    SS.reset_launches()
    t0 = time.perf_counter()
    try:
        with book_local_problems() as problems, CollectiveCounter(mesh) \
                as counter:
            state, metrics = step_fn(state, batch)
    finally:
        AFTER_FORWARD.clear()
    if cuda:
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {**FA.LAUNCHES, **SS.LAUNCHES}
    kflops, pad_flops = _flops(problems, launches)
    peak = (torch.cuda.max_memory_allocated() - base) if cuda else None
    logits = _logits_bytes(cfg, rows, shape.seq_len, mesh)
    saved = (marks[0] - base - logits) if marks else None
    parts = {"state": arg_bytes, "saved_activations": saved,
             "logits_and_gradient": 2 * logits,
             "rest": (None if saved is None
                      else peak - saved - 2 * logits)}
    return {
        "flops": float(counter.flops + kflops),
        "aten_flops": float(counter.flops),
        "kernel_flops": float(kflops),
        "kernel_padding_flops": float(pad_flops),
        "collective_bytes_per_device": counter.per_device(),
        "collective_bytes_by_phase_axis": counter.by_phase_axis,
        "collectives": counter.table(),
        "dp_gradient_bytes": dp_gradient_bytes(counter.by_phase_axis),
        "collective_calls": counter.calls,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": arg_bytes,
                   "temp_bytes": (None if peak is None
                                  else max(0, peak - arg_bytes)),
                   "peak_bytes": peak, "alias_bytes": None,
                   "generated_code_bytes": None, "peak_parts": parts},
        "launches": {k: int(v) for k, v in launches.items() if v},
        "kernel_problems": {family: [[*problem, calls] for problem, calls
                                     in seen.items()]
                            for family, seen in problems.items()},
        "step_seconds": step_s,
        "per_device_batch": [rows, shape.seq_len],
        "memory_tokens": n_mem,
    }


def decode_context(cfg: ArchConfig, seq_len: int) -> int:
    """A decode cell's cache slots: the reference's context,
    ``min(seq_len, window)`` (its ``_lower_decode``)."""
    return seq_len if cfg.window is None else min(seq_len, cfg.window)


def _local_bytes(t) -> int:
    t = t.to_local() if hasattr(t, "to_local") else t
    return t.numel() * t.element_size()


def _cache_leaves(cache):
    """``(name, leaf)`` of every leaf of a serve cache (a list of per-layer
    dicts, or ``{"layers": [...], "enc_memory": ...}``): a leaf by its
    name, but a cross layer's ``k`` / ``v`` (those of a dict without
    ``kpos``: an ``xattn`` layer's mixer, a ``dec_xattn`` layer's
    ``cross``) as ``cross_k`` / ``cross_v``."""
    from ..models.transformer import layers_of

    for layer in layers_of(cache):
        for part in layer.values():
            cross = "k" in part and "kpos" not in part
            for name, t in part.items():
                yield (f"cross_{name}" if cross else name), t
    if isinstance(cache, dict):
        yield "enc_memory", cache["enc_memory"]


def cache_bytes(cache) -> dict:
    """The local bytes of a cache's leaves by leaf name (``k``, ``v``,
    ``kpos``, ``ckv``, ``krope``, ``conv``, ``state``, ``cross_k``,
    ``cross_v``, ``enc_memory``), over every layer."""
    out: dict[str, int] = {}
    for name, t in _cache_leaves(cache):
        out[name] = out.get(name, 0) + _local_bytes(t)
    return out


def reckon_cache_bytes(cfg: ArchConfig, rows: int, slots: int,
                       model: int = 16, memory_len: int = 0) -> dict:
    """A decode cell's cache bytes a device by leaf name (as
    :func:`cache_bytes` names them) from the config alone: each layer's
    leaves at ``rows`` rows, ``slots`` attention slots and, for a cross
    layer, the memory's ``memory_len`` positions, a ``kv_heads`` or
    ``ff`` dim split ``model`` ways where it divides it (the reference's
    ``cache_logical_axes`` and rules; MLA's latents and ``enc_memory``
    only over the batch); bf16 k, v, ckv, krope, conv and the memory,
    int32 kpos, float32 states."""
    def cut(n):
        return n // model if n % model == 0 else n
    out: dict[str, int] = {}

    def add(name, n):
        out[name] = out.get(name, 0) + n

    def attn(prefix, heads, n_slots):
        for name in ("k", "v"):
            add(prefix + name, rows * cut(heads) * n_slots
                * cfg.resolved_head_dim * 2)

    from ..models.transformer import layer_plan
    for kind in layer_plan(cfg).kinds:
        if kind == "attn" and cfg.mla is not None:
            add("ckv", rows * slots * cfg.mla.kv_lora * 2)
            add("krope", rows * slots * cfg.mla.qk_rope * 2)
        elif kind in ("attn", "dec_xattn"):
            attn("", cfg.n_kv_heads, slots)
            add("kpos", rows * slots * 4)
        elif kind == "ssd":
            ssm = cfg.ssm
            d_inner = ssm.expand * cfg.d_model
            add("conv", rows * (ssm.d_conv - 1)
                * cut(d_inner + 2 * ssm.n_groups * ssm.d_state) * 2)
            add("state", rows * (d_inner // ssm.head_dim) * ssm.d_state
                * ssm.head_dim * 4)
        elif kind == "rglru":
            w = cfg.rglru.lru_width or cfg.d_model
            add("conv", rows * (cfg.rglru.d_conv - 1) * cut(w) * 2)
            add("state", rows * cut(w) * 4)
        elif kind != "xattn":
            raise ValueError(f"no cache reckoning for {kind!r} layers")
        if kind in ("xattn", "dec_xattn"):
            attn("cross_", max(1, cfg.n_kv_heads), memory_len)
    if cfg.encoder is not None or cfg.vision is not None:
        add("enc_memory", rows * memory_len * cfg.d_model * 2)
    return out


def local_cache(cfg: ArchConfig, mesh, batch: int, seq_len: int, device,
                seed: int = 0):
    """Rank 0's blocks of a decode cell's cache as DTensors on ``mesh``:
    the cache of a prefill into :func:`decode_context` slots
    (:meth:`~repro_torch.models.model.ModelBundle.cache_shapes`; a
    memory config's cross layers and ``enc_memory`` at
    :func:`memory_tokens` positions), each leaf placed by
    :func:`~repro_torch.models.model.cache_specs`, with seeded values
    (standard normal, the states times 0.1) and ``kpos`` as a prefill of
    ``seq_len - 1`` tokens leaves it (:func:`~repro_torch.models.layers.
    slot_positions`), so that the one new token at position ``seq_len -
    1`` takes slot ``(seq_len - 1) mod slots`` (MLA's latents: slot
    ``seq_len - 1`` of ``seq_len``)."""
    from torch.utils._pytree import tree_map_with_path

    from ..models import build
    from ..models.common import local_shape
    from ..models.layers import slot_positions
    from ..models.model import cache_specs

    slots = decode_context(cfg, seq_len)
    shapes = build(cfg).cache_shapes(
        batch, slots, memory_tokens(cfg, seq_len) or None)
    specs = cache_specs(shapes, mesh)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 2)
    kpos = slot_positions(seq_len - 1, slots, device)

    def make(path, t):
        name = path[-1].key
        spec = specs
        for key in path:
            spec = spec[key.key if hasattr(key, "key") else key.idx]
        shape = local_shape(tuple(t.shape), spec, mesh)
        if name == "kpos":
            local = kpos[None, :].repeat(shape[0], 1)
        else:
            local = torch.randn(shape, generator=gen, device=device)
            local = (local * 0.1 if name == "state" else local).to(t.dtype)
        return _from_local(local, mesh, spec, tuple(t.shape))

    return tree_map_with_path(make, shapes)


def _serve_metrics(cfg: ArchConfig, shape: ShapeConfig, mesh, device,
                   seed: int = 0) -> dict:
    """Run rank 0's share of one prefill (``shape.kind == "prefill"``:
    the cell's rows of ``seq_len`` tokens) or one decode step (one token
    a row against :func:`local_cache`) of ``shape`` on ``mesh`` and
    measure it (see the module's docstring)."""
    from ..data import DataConfig, synthetic_batch
    from ..kernels import flash_attention as FA
    from ..kernels import ssd_scan as SS
    from ..models import Model, build
    from ..models.common import axis_sizes
    from torch.utils._pytree import tree_leaves

    from ..models.layers import batch_axes_for, book_local_problems
    from ..train.train_step import _bind, _phase

    bundle = build(cfg)
    params = local_params(cfg, mesh, bundle.param_specs(mesh), device, seed)
    model = Model(cfg, device="meta")
    _bind(model, params)
    b = shape.global_batch
    axes = tuple(batch_axes_for(mesh, b, True))
    sizes = axis_sizes(mesh)
    rows = b // int(np.prod([sizes[a] for a in axes]))
    bspec = (axes or None, None)
    decode = shape.kind == "decode"
    cache = None
    if decode:
        gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
        tokens = _from_local(torch.randint(
            0, cfg.vocab, (rows, 1), generator=gen, device=device), mesh,
            bspec, (b, 1))
        positions = _from_local(torch.full(
            (rows, 1), shape.seq_len - 1, dtype=torch.int64, device=device),
            mesh, bspec, (b, 1))
        cache = local_cache(cfg, mesh, b, shape.seq_len, device, seed)
    n_mem = memory_tokens(cfg, shape.seq_len)
    memory = None
    if not decode:
        data = DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                          global_batch=b, seed=seed)
        tokens = _from_local(torch.as_tensor(synthetic_batch(
            data, 0, slice(0, rows))["tokens"], device=device), mesh, bspec,
            (b, shape.seq_len))
        if n_mem:
            # the stub frontend's embeddings, made on the device (their
            # values are not read as results)
            gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
            memory = _from_local(
                torch.randn((rows, n_mem, cfg.d_model), generator=gen,
                            device=device).to(torch.bfloat16), mesh,
                bspec + (None,), (b, n_mem, cfg.d_model))
    param_bytes = _state_bytes(params)
    mem_bytes = (_local_bytes(memory) if memory is not None else
                 cache_bytes(cache).get("enc_memory", 0) if decode else 0)
    cache_in = cache_bytes(cache) if decode else {}
    in_ptrs = {t.to_local().data_ptr() for t in tree_leaves(
        cache if decode else [memory] if memory is not None else [])}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    FA.reset_launches()
    SS.reset_launches()
    t0 = time.perf_counter()
    with _phase(shape.kind), book_local_problems() as problems, \
            CollectiveCounter(mesh) as counter:
        if decode:
            logits, out_cache = bundle.decode_step(model, cache, tokens,
                                                   positions, mesh=mesh)
        else:
            logits, out_cache = bundle.prefill(model, tokens, memory=memory,
                                               mesh=mesh)
    if cuda:
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {**FA.LAUNCHES, **SS.LAUNCHES}
    kflops, pad_flops = _flops(problems, launches)
    peak = (torch.cuda.max_memory_allocated() - base) if cuda else None
    logit_bytes = _local_bytes(logits)
    cache_out = cache_bytes(out_cache)
    new_cache = sum(_local_bytes(t) for t in tree_leaves(out_cache)
                    if t.to_local().data_ptr() not in in_ptrs)
    rest = None if peak is None else peak - logit_bytes - new_cache
    return {
        "flops": float(counter.flops + kflops),
        "aten_flops": float(counter.flops),
        "kernel_flops": float(kflops),
        "kernel_padding_flops": float(pad_flops),
        "collective_bytes_per_device": counter.per_device(),
        "collective_bytes_by_phase_axis": counter.by_phase_axis,
        "collectives": counter.table(),
        "dp_gradient_bytes": {},
        "collective_calls": counter.calls,
        "memory": {
            "argument_bytes": param_bytes + sum(cache_in.values())
            + (mem_bytes if not decode else 0),
            "output_bytes": logit_bytes + sum(cache_out.values()),
            "temp_bytes": None if rest is None else max(0, rest),
            "peak_bytes": peak, "alias_bytes": None,
            "generated_code_bytes": None,
            "peak_parts": {"params": param_bytes,
                           "cache": sum(cache_out.values()),
                           "logits": logit_bytes, "rest": rest,
                           **({"memory": mem_bytes} if n_mem else {})},
            "cache_parts": cache_out},
        "launches": {k: int(v) for k, v in launches.items() if v},
        "kernel_problems": {family: [[*problem, calls] for problem, calls
                                     in seen.items()]
                            for family, seen in problems.items()},
        "step_seconds": step_s,
        "per_device_batch": [rows, 1 if decode else shape.seq_len],
        "context": decode_context(cfg, shape.seq_len) if decode
        else shape.seq_len,
        "memory_tokens": n_mem,
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool, device=None, *,
               cfg: ArchConfig | None = None, shape: ShapeConfig | None = None,
               seed: int = 0) -> dict:
    """Run cell (arch, shape, mesh) as rank 0 of the production mesh on
    ``device`` (default: the card; ``"cpu"`` to run the kernels' plain
    versions on the CPU) and return its record.  ``cfg`` / ``shape``
    override the published config and the named shape (a reduced config,
    a small shape)."""
    from .._device import resolve_device
    from .mesh import make_production_mesh

    cfg = cfg if cfg is not None else get_arch(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    reason = _skip_reason(cfg, shape)
    if reason is not None:
        return {"status": "skipped", "arch": arch, "shape": shape_name,
                "mesh": mesh_name, "reason": reason}
    device = resolve_device(device)
    if device.type == "cuda":
        from ..kernels._build import extension
        extension()                     # the kernels' build is set-up
    n = 512 if multi_pod else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device.type)
        metrics = _step_metrics if shape.kind == "train" else \
            _serve_metrics
        main = metrics(cfg, shape, mesh, device, seed)
    return {
        "status": "ok", "arch": arch, "shape": shape_name,
        "mesh": mesh_name,
        "perf_flags": os.environ.get("REPRO_PERF", ""),
        "n_devices": n, "scan_reps": 0, "device": str(device),
        "compile_seconds": None, "hlo_chars": None, "raw": None,
        "probe": None, "bytes_accessed": None, "transcendentals": None,
        **main,
    }


def cell_path(arch, shape_name, mesh_name):
    os.makedirs(OUT_DIR, exist_ok=True)
    return os.path.join(OUT_DIR, f"{arch}__{shape_name}__{mesh_name}.json")


def run_cell(arch, shape_name, multi_pod, force=False, device=None):
    """:func:`lower_cell`, its record written under :data:`OUT_DIR`
    (and read from there unless ``force``); a failure is recorded."""
    mesh_name = "pod2" if multi_pod else "pod1"
    path = cell_path(arch, shape_name, mesh_name)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    t0 = time.time()
    try:
        result = lower_cell(arch, shape_name, multi_pod, device)
    except Exception as e:  # record failures: they are bugs to fix
        result = {"status": "error", "arch": arch, "shape": shape_name,
                  "mesh": mesh_name, "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    result["wall_seconds"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=[*sorted(ARCHS), None])
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "the kernels' plain versions on the CPU)")
    args = ap.parse_args(argv)

    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[
        args.mesh]
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    ok = err = skip = 0
    for a, s, mp in cells:
        r = run_cell(a, s, mp, force=args.force, device=args.device)
        tag = r["status"]
        ok += tag == "ok"
        err += tag == "error"
        skip += tag == "skipped"
        msg = r.get("error", "")[:120] if tag == "error" else (
            f"flops={r.get('flops', 0):.3e} "
            f"coll={r['collective_bytes_per_device']['total']:.3e}B"
            if tag == "ok" else r.get("reason", ""))
        print(f"[{tag:7s}] {a:24s} {s:12s} {'pod2' if mp else 'pod1'}  "
              f"{msg}", flush=True)
        if tag == "ok":
            mem = r["memory"]
            temp = mem["temp_bytes"]
            print(f"          memory/device: "
                  f"args={mem['argument_bytes'] / 2**30:.2f}GiB "
                  f"temp={'n/a' if temp is None else f'{temp / 2**30:.2f}'}"
                  f"GiB step={r['step_seconds']:.2f}s", flush=True)
    print(f"done: {ok} ok, {skip} skipped, {err} errors")
    sys.exit(1 if err else 0)


if __name__ == "__main__":
    main()
