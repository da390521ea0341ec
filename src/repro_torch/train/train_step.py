"""The train step: loss and gradients through the model (flash-attention
forward and backward kernels, remat per block), optional error-feedback
int8 compression of the gradients, then AdamW.

Counterpart of ``repro/train/train_step.py`` on one device.  The train
state is a dict ``{"params": {name: tensor}, "opt": {"m": {...}, "v":
{...}, "count": int32}, "step": int32[, "ef": {...}]}``, the parameter
names those of :class:`~repro_torch.models.Model`.  ``step_fn(state,
batch) -> (state, metrics)`` donates the old state by default, as the
reference's jitted step does: params, moments, count and step are
updated in place (:func:`~repro_torch.optim.adamw_update_`), leaf by
leaf, and the returned state holds the same tensors.  With
``donate=False`` it returns new tensors and leaves the old state as it
was; both give the same bits.  Donation is what lets a 3.4B-parameter
float32 state (params, gradients and two moments: 54 GB) train on one
80 GB card, where a second params, m and v would not fit.

The ``microbatch`` perf flag (``REPRO_PERF=microbatch=N``) accumulates
gradients inside the step as the reference does: where N > 1 divides
the batch, the batch splits into N microbatches of consecutive rows,
and ``g_acc + g / N`` runs from zeros in microbatch order, leaf by leaf
in place (one more set of gradients beside the state, not two), loss
and metrics averaged the same way; otherwise the plain step runs.

On a mesh (``mesh``, a ``DeviceMesh`` of more than one device; every
family) the state's tensors are DTensors placed by
:func:`make_train_state_specs` (the reference's specs: params, m and v
by the parameter specs, ``count`` and ``step`` replicated) and the
batch, its tokens and a memory-input config's memory, is sharded over
the batch axes (:func:`batch_pspec`).  The loss
runs with ``mesh`` and its backward under ``loss_parallel``; then each
gradient is reduced explicitly to its parameter's placements, before the
clip and AdamW: the data-parallel all-reduce (a weight sharded over the
batch axes, ``fsdp``, gets its gradient by reduce-scatter already in the
backward).  ``zero1=True`` is the reference's rule: a gradient whose
parameter is replicated and whose first dim the ``data`` axis divides is
reduce-scattered over ``data`` instead, its AdamW moments are kept
sharded over ``data`` (ZeRO-1: each data rank owns a slice of the
optimizer state; the reference keeps m and v at the parameter's spec and
leaves the layout to GSPMD), the update runs on the slice, and the
parameter comes back by all-gather.  A one-device mesh shards nothing:
the step is the plain one, ``zero1`` included, bit for bit.

The ``microbatch`` flag on a mesh follows the reference's rule on the
global batch: where N > 1 divides it, microbatch i is the global rows
``[i B / N, (i + 1) B / N)`` (an MoE's aux loss is per microbatch, so
which rows form one matters), each placed over the batch axes again, as
the reference's ``with_sharding_constraint(..., P(None, *bspec))``
places it; a microbatch whose rows the batch axes do not divide raises
``ValueError`` (DTensor's uneven shards would leave some ranks a row
short of the others; the reference pads them).  A global array that
every rank holds is cut before it is distributed (no byte moves); a
DTensor batch is routed block by block with explicit all-to-alls over
the batch axes (:func:`_split_rows`).  Each microbatch's gradients,
still partial sums, are added ``/ N`` from zeros in microbatch order
into local tensors (one set of gradients beside the state), and the
data-parallel reduction runs once, on the sum.  ``grad_compress``
(error-feedback int8, :func:`~repro_torch.optim.ef_compress_grads`)
runs after that reduction, on the gradients at their parameters'
placements (a ZeRO-1 leaf's gradient is all-reduced then, as the
replicated error needs the whole sum on every rank), and before the
ZeRO-1 slice and AdamW, the reference's order; its error leaves ``ef``
sit at the parameters' placements.

``COLLECTIVE_PHASE`` names the part of the step that is running, so
that the dry run can book each collective to it: ``"split"`` (a DTensor
batch's microbatches routed over the batch axes), ``"loss"`` (forward
and backward), ``"gradients"`` (the data-parallel reduction),
``"compress"`` (the gathers of the leaves that ``grad_compress`` cannot
compress in place) and ``"optimizer"`` (the clip's norm, ZeRO-1's
all-gathers).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

import contextlib

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..models import Model, build
from ..models.common import (DEFAULT_RULES, ShardingRules, axis_sizes,
                             placements)
from ..optim import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                     adamw_update_, ef_compress_grads, ef_init)
from ..perf import flags

__all__ = ["TrainStepConfig", "init_train_state", "train_state_from_model",
           "make_train_step", "make_train_state_specs", "batch_pspec",
           "COLLECTIVE_PHASE", "AFTER_FORWARD", "AFTER_SPLIT"]

COLLECTIVE_PHASE = {"name": None}
# callables the mesh step calls with no argument between its forward and
# its backward (the dry run reads the card's memory there)
AFTER_FORWARD: list = []
# callables the mesh step calls with the list of its microbatches (dicts
# of DTensors) once it has split the batch (the dry run's fake group
# leaves an all-to-all's output unwritten, and the dry run refills it)
AFTER_SPLIT: list = []


@contextlib.contextmanager
def _phase(name: str):
    prev = COLLECTIVE_PHASE["name"]
    COLLECTIVE_PHASE["name"] = name
    try:
        yield
    finally:
        COLLECTIVE_PHASE["name"] = prev


@dataclass(frozen=True)
class TrainStepConfig:
    optimizer: AdamWConfig = AdamWConfig()
    grad_compress: bool = False       # error-feedback int8
    zero1: bool = False               # reduce-scatter/all-gather grad path
    rules: ShardingRules = DEFAULT_RULES


def _opt_cfg(cfg: ArchConfig, ts: TrainStepConfig) -> AdamWConfig:
    """bf16 AdamW moments for bf16-param archs, as the reference."""
    if cfg.bf16_params and ts.optimizer.state_dtype == torch.float32:
        return dataclasses.replace(ts.optimizer, state_dtype=torch.bfloat16)
    return ts.optimizer


def train_state_from_model(cfg: ArchConfig, model: Model,
                           ts: TrainStepConfig = TrainStepConfig()) -> dict:
    """A fresh train state holding ``model``'s weights (shared, not
    copied)."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    state = {"params": params,
             "opt": adamw_init(params, _opt_cfg(cfg, ts))._asdict(),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=model.device)}
    if ts.grad_compress:
        state["ef"] = ef_init(params)
    return state


def init_train_state(cfg: ArchConfig, seed: int = 0,
                     ts: TrainStepConfig = TrainStepConfig(),
                     device=None) -> dict:
    """A fresh train state with weights from a ``torch.Generator`` seeded
    with ``seed``, on ``device`` (default: the card)."""
    return train_state_from_model(cfg, build(cfg).init(seed, device), ts)


def _bind(model: Model, params: dict) -> dict:
    """Make ``params`` the model's parameters (sharing their storage) as
    leaves that record gradients; returns them by name."""
    bound = {}
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        p = nn.Parameter(t)
        model.get_submodule(owner)._parameters[leaf] = p
        bound[name] = p
    return bound


def _device_batch(batch, device) -> dict:
    """The batch on ``device``: ``tokens`` and, where given, ``memory``
    (the frame or image embeddings of a memory-input config)."""
    out = {"tokens": torch.as_tensor(batch["tokens"], device=device)}
    if batch.get("memory") is not None:
        out["memory"] = torch.as_tensor(batch["memory"], device=device)
    return out


def _zero1_leaf(spec, shape, dsize: int) -> bool:
    """The reference's ZeRO-1 rule: a replicated leaf whose first dim
    the data axis (of size ``dsize`` > 1) divides."""
    return (all(a is None for a in spec) and len(shape) > 0
            and shape[0] % dsize == 0 and dsize > 1)


def make_train_state_specs(cfg: ArchConfig, mesh,
                           ts: TrainStepConfig = TrainStepConfig()) -> dict:
    """The spec tree of the whole train state: params, m and v by the
    parameter specs (m and v of a ZeRO-1 leaf over ``data`` on dim 0
    under ``zero1``), ``count`` and ``step`` replicated."""
    bundle = build(cfg)
    pspecs = bundle.param_specs(mesh, ts.rules)
    mspecs = dict(pspecs)
    if ts.zero1:
        from ..models.model import param_shapes
        dsize = axis_sizes(mesh).get("data", 1)
        for name, (shape, _) in param_shapes(cfg).items():
            if _zero1_leaf(pspecs[name], shape, dsize):
                mspecs[name] = ("data",) + (None,) * (len(shape) - 1)
    specs = {"params": pspecs,
             "opt": {"m": mspecs, "v": dict(mspecs), "count": ()},
             "step": ()}
    if ts.grad_compress:
        specs["ef"] = dict(pspecs)
    return specs


def batch_pspec(mesh) -> tuple:
    """The batch's spec: dim 0 over the mesh's ``("pod", "data")``
    axes."""
    axes = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    return (axes or None,)


def make_train_step(cfg: ArchConfig, device=None,
                    ts: TrainStepConfig = TrainStepConfig(),
                    donate: bool = True, mesh=None):
    """``step_fn(state, batch) -> (new_state, metrics)`` on ``device``
    (default: the card).  ``batch["tokens"]`` (B, S) integer tensor or
    array, plus ``batch["memory"]`` (B, T, M) for a memory-input config;
    metrics ``loss``, ``ce``, ``aux`` (and ``mtp`` for an MTP config),
    ``grad_norm`` and ``lr``, scalar tensors on the device.  ``donate``:
    update the old state in place (see the module's docstring).
    ``mesh``: a ``DeviceMesh``; the state's tensors are then DTensors by
    :func:`make_train_state_specs` and ``batch["tokens"]`` a DTensor or
    a global array that every rank holds (see the module's docstring)."""
    if mesh is not None and mesh.size() > 1:
        return _make_mesh_step(cfg, ts, donate, mesh)
    device = resolve_device(device)
    bundle = build(cfg)
    model = Model(cfg, device="meta")      # weights bound at every step
    opt_cfg = _opt_cfg(cfg, ts)

    def value_and_grad(params, batch):
        loss, metrics = bundle.loss(model, batch)
        names = list(params)
        # a weight the loss never reads (a MoE's shared-expert norm, which
        # the reference carries unused too) gets a zero gradient
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names], allow_unused=True,
            materialize_grads=True)))
        return loss.detach(), {k: v.detach() for k, v in
                               metrics.items()}, grads

    def accumulated(params, batch, mb: int):
        """The reference's microbatch scan: sums of ``x / mb`` from
        zeros, in microbatch order."""
        g_acc = {n: torch.zeros_like(p) for n, p in params.items()}
        loss_acc, m_acc = None, None
        for part in zip(*(t.chunk(mb) for t in batch.values())):
            loss, metrics, grads = value_and_grad(
                params, dict(zip(batch, part)))
            for n in list(grads):
                g_acc[n].add_(grads.pop(n) / mb)
            if loss_acc is None:
                loss_acc = torch.zeros_like(loss)
                m_acc = {k: torch.zeros_like(v) for k, v in metrics.items()}
            loss_acc += loss / mb
            for k, v in metrics.items():
                m_acc[k] += v / mb
        return loss_acc, m_acc, g_acc

    def step_fn(state, batch):
        params = _bind(model, state["params"])
        batch = _device_batch(batch, device)
        mb = int(flags().microbatch)
        if mb > 1 and batch["tokens"].shape[0] % mb == 0:
            loss, metrics, grads = accumulated(params, batch, mb)
        else:
            loss, metrics, grads = value_and_grad(params, batch)
        if ts.grad_compress:
            grads, new_ef = ef_compress_grads(grads, state["ef"])
        opt = AdamWState(state["opt"]["m"], state["opt"]["v"],
                         state["opt"]["count"])
        if donate:
            new_params, new_opt, opt_metrics = adamw_update_(
                grads, opt, state["params"], opt_cfg)
            step = state["step"].add_(1)
            if ts.grad_compress:
                for key, e in new_ef.items():
                    state["ef"][key].copy_(e)
                new_ef = state["ef"]
        else:
            new_params, new_opt, opt_metrics = adamw_update(
                grads, opt, state["params"], opt_cfg)
            _bind(model, new_params)       # drop the old weights
            step = state["step"] + 1
        new_state = {"params": new_params, "opt": new_opt._asdict(),
                     "step": step}
        if ts.grad_compress:
            new_state["ef"] = new_ef
        metrics = {"loss": loss, **metrics, **opt_metrics}
        return new_state, metrics

    return step_fn


def _placed(t, mesh):
    """``t`` as a DTensor over the batch axes on dim 0: kept where it is
    one, else each rank takes its rows of the global array it holds (no
    byte moves)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t
    dev = torch.device(mesh.device_type)
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return distribute_tensor(torch.as_tensor(t, device=dev), mesh,
                             placements(batch_pspec(mesh), mesh),
                             src_data_rank=None)


def _mesh_batch(batch, mesh) -> dict:
    """``batch["tokens"]`` and, where the batch has one, its ``memory``
    (B, T, M) in bf16, each a DTensor over the batch axes (the
    reference's ``in_shardings``, :func:`_placed`)."""
    out = {}
    for key in ("tokens", "memory"):
        t = batch.get(key)
        if t is not None:
            t = _placed(t, mesh)
            out[key] = t.to(torch.bfloat16) if key == "memory" else t
    return out


def _batch_dims(mesh) -> list:
    """The mesh dims of the batch axes, outermost first."""
    return [mesh.mesh_dim_names.index(a)
            for a in (batch_pspec(mesh)[0] or ())]


def _microbatch_rows(bsz: int, mb: int, mesh) -> int:
    """Rows of a microbatch of a global batch of ``bsz``, which the
    batch axes must divide (see the module's docstring)."""
    n = 1
    for d in _batch_dims(mesh):
        n *= mesh.size(d)
    rows = bsz // mb
    if rows % n:
        raise ValueError(
            f"microbatch={mb}: a microbatch of {rows} of the batch's {bsz} "
            f"rows does not divide over the batch axes' {n} devices, and "
            f"DTensor would give some ranks fewer rows than others (the "
            f"reference pads them); pick a microbatch count that leaves a "
            f"multiple of {n} rows")
    return rows


def _split_rows(t, mesh, mb: int) -> list:
    """The ``mb`` microbatches of a DTensor ``t`` sharded over the batch
    axes on dim 0, each again over the batch axes: microbatch i holds
    the global rows ``[i B / mb, (i + 1) B / mb)``.  Each rank's rows
    are ``mb`` blocks of ``c = B / (mb n)`` rows; global block b goes to
    rank ``b mod n`` as its rows of microbatch ``b // n``.  The blocks
    are routed by one all-to-all over each batch axis, the innermost
    first, each block moving to its destination's coordinate on that
    axis; every rank reckons every rank's blocks, so the split sizes
    agree on both ends."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor

    dims = _batch_dims(mesh)
    sizes = [mesh.size(d) for d in dims]
    n = 1
    for k in sizes:
        n *= k
    rows = _microbatch_rows(t.shape[0], mb, mesh)
    c = rows // n

    def coords(r):
        out = []
        for k in reversed(sizes):
            out.append(r % k)
            r //= k
        return out[::-1]

    def flat(cs):
        r = 0
        for x, k in zip(cs, sizes):
            r = r * k + x
        return r

    me = flat([mesh.get_local_rank(d) for d in dims])
    held = {r: [r * mb + k for k in range(mb)] for r in range(n)}
    blocks = list(t.to_local().split(c))
    for j in reversed(range(len(dims))):
        def dest(b, j=j):
            return coords(b % n)[j]
        if all(dest(b) == coords(r)[j] for r, bs in held.items()
               for b in bs):
            continue
        sends = {r: sorted(bs, key=dest) for r, bs in held.items()}
        mine = coords(me)
        src = [flat(mine[:j] + [s] + mine[j + 1:]) for s in range(sizes[j])]
        got = {s: [b for b in sends[r] if dest(b) == mine[j]]
               for s, r in enumerate(src)}
        order = [held[me].index(b) for b in sends[me]]
        out = funcol.all_to_all_single(
            torch.cat([blocks[i] for i in order]),
            [len(got[s]) * c for s in range(sizes[j])],
            [sum(dest(b) == x for b in sends[me]) * c
             for x in range(sizes[j])], (mesh, dims[j]))
        if hasattr(out, "wait"):
            out = out.wait()
        blocks = list(out.split(c))
        new = {}
        for r in held:
            cs = coords(r)
            new[r] = [b for s in range(sizes[j])
                      for b in sends[flat(cs[:j] + [s] + cs[j + 1:])]
                      if dest(b) == cs[j]]
        held = new
    order = sorted(range(mb), key=lambda i: held[me][i])
    shape = (rows, *t.shape[1:])
    stride = tuple(int(torch.Size(shape[k + 1:]).numel())
                   for k in range(len(shape)))
    return [DTensor.from_local(blocks[i], mesh, tuple(t.placements),
                               run_check=False, shape=torch.Size(shape),
                               stride=stride) for i in order]


def _microbatches(batch, mesh, mb: int) -> list:
    """The mesh batch (:func:`_mesh_batch`) as ``mb`` microbatches of
    consecutive global rows, each over the batch axes (see the module's
    docstring): a global array is cut before it is distributed, a
    DTensor routed by :func:`_split_rows` under the phase ``"split"``."""
    from torch.distributed.tensor import DTensor

    rows = _microbatch_rows(int(batch["tokens"].shape[0]), mb, mesh)
    parts = [{} for _ in range(mb)]
    for key in ("tokens", "memory"):
        t = batch.get(key)
        if t is None:
            continue
        if isinstance(t, DTensor):
            with _phase("split"):
                cut = _split_rows(t, mesh, mb)
        else:
            cut = [_placed(t[i * rows:(i + 1) * rows], mesh)
                   for i in range(mb)]
        for part, x in zip(parts, cut):
            part[key] = x.to(torch.bfloat16) if key == "memory" else x
    for fn in AFTER_SPLIT:
        fn(parts)
    return parts


def _reduce_grad(g, mesh, want):
    """Gradient ``g`` (a DTensor, partial sums over the batch axes) at
    placements ``want``: first the blocks that the gradient holds whole
    and the parameter holds sliced are sliced (no bytes move), then the
    partial sums are reduced, so that each device reduces its block and
    no more."""
    mid = tuple(w if (p.is_replicate() and w.is_shard()) else p
                for p, w in zip(g.placements, want))
    if mid != tuple(g.placements):
        g = g.redistribute(mesh, mid)
    return g if tuple(g.placements) == tuple(want) else \
        g.redistribute(mesh, want)


def _local(t):
    """A replicated DTensor's local value, or ``t``."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _make_mesh_step(cfg: ArchConfig, ts: TrainStepConfig, donate: bool,
                    mesh):
    """The train step on a mesh (see the module's docstring)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.parallel import loss_parallel

    bundle = build(cfg)
    model = Model(cfg, device="meta")      # weights bound at every step
    opt_cfg = _opt_cfg(cfg, ts)
    specs = make_train_state_specs(cfg, mesh, ts)
    want = {n: placements(sp, mesh) for n, sp in specs["params"].items()}
    grad_to = {n: placements(sp, mesh) for n, sp in specs["opt"]["m"]
               .items()}
    # the reduction's target: the ZeRO-1 slice, or under grad_compress
    # the parameter's placements (the slice is cut after compression)
    reduce_to = want if ts.grad_compress else grad_to

    def value_and_grad(params, names, batch):
        with loss_parallel(), _phase("loss"):
            loss, metrics = bundle.loss(model, batch, mesh=mesh)
            for fn in AFTER_FORWARD:
                fn()
            grads = list(torch.autograd.grad(
                loss, [params[n] for n in names], allow_unused=True,
                materialize_grads=True))
        return (_local(loss.detach()),
                {k: _local(v.detach()) for k, v in metrics.items()}, grads)

    def accumulated(params, names, parts):
        """The reference's microbatch scan on the unreduced gradients:
        sums of ``x / mb`` from zeros in microbatch order, leaf by leaf
        on the local tensors."""
        mb = len(parts)
        acc = loss_acc = m_acc = None
        for part in parts:
            loss, metrics, grads = value_and_grad(params, names, part)
            if acc is None:
                acc = [(torch.zeros_like(g.to_local()), tuple(g.placements),
                        g.shape, g.stride()) for g in grads]
                loss_acc = torch.zeros_like(loss)
                m_acc = {k: torch.zeros_like(v) for k, v in metrics.items()}
            for i, name in enumerate(names):
                g, grads[i] = grads[i], None
                if tuple(g.placements) != acc[i][1]:
                    raise RuntimeError(
                        f"{name}: its gradient's placements "
                        f"{tuple(g.placements)} differ between microbatches "
                        f"(first {acc[i][1]})")
                acc[i][0].add_(g.to_local() / mb)
                del g
            loss_acc += loss / mb
            for k, v in metrics.items():
                m_acc[k] += v / mb
        grads = [DTensor.from_local(a, mesh, pl, run_check=False,
                                    shape=shape, stride=stride)
                 for a, pl, shape, stride in acc]
        return loss_acc, m_acc, grads

    def step_fn(state, batch):
        params = _bind(model, state["params"])
        names = list(params)
        mb = int(flags().microbatch)
        if mb > 1 and batch["tokens"].shape[0] % mb == 0:
            loss, metrics, grads = accumulated(
                params, names, _microbatches(batch, mesh, mb))
        else:
            loss, metrics, grads = value_and_grad(
                params, names, _mesh_batch(batch, mesh))
        with _phase("gradients"):
            # the data-parallel reduction (reduce-scatter of a ZeRO-1
            # leaf), explicit and leaf by leaf
            grads = {n: _reduce_grad(g, mesh, reduce_to[n])
                     for n, g in zip(names, grads)}
        if ts.grad_compress:
            with _phase("compress"):
                grads, new_ef = ef_compress_grads(grads, state["ef"])
            # a ZeRO-1 leaf's slice of the compressed gradient (no byte
            # moves: each rank cuts its rows)
            grads = {n: g if tuple(g.placements) == grad_to[n]
                     else g.redistribute(mesh, grad_to[n])
                     for n, g in grads.items()}
        opt = AdamWState(state["opt"]["m"], state["opt"]["v"],
                         state["opt"]["count"])
        with _phase("optimizer"):
            if donate:
                new_params, new_opt, opt_metrics = adamw_update_(
                    grads, opt, state["params"], opt_cfg)
                step = state["step"].add_(1)
                if ts.grad_compress:
                    with torch.no_grad():
                        for key, e in new_ef.items():
                            state["ef"][key].copy_(e)
                    new_ef = state["ef"]
            else:
                new_params, new_opt, opt_metrics = adamw_update(
                    grads, opt, state["params"], opt_cfg)
                # a ZeRO-1 leaf's slice comes back by all-gather
                new_params = {n: p if tuple(p.placements) == want[n]
                              else p.redistribute(mesh, want[n])
                              for n, p in new_params.items()}
                _bind(model, new_params)
                step = state["step"] + 1
        new_state = {"params": new_params, "opt": new_opt._asdict(),
                     "step": step}
        if ts.grad_compress:
            new_state["ef"] = new_ef
        metrics = {"loss": loss, **metrics, **opt_metrics}
        metrics = {k: _local(v) for k, v in metrics.items()}
        return new_state, metrics

    return step_fn
