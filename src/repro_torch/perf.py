"""Performance-experiment flags, read from ``REPRO_PERF`` at import.

Counterpart of ``repro/perf.py``, with its fields, defaults and order
and its parsing:

  REPRO_PERF="prob_bf16,gqa_grouped,microbatch=2" \\
      python -m repro_torch.launch.train --arch smollm-135m ...

or ``perf.set_flags(prob_bf16=True)`` from code (an unknown name raises
``KeyError``).  ``from_env`` reads comma-separated tokens: ``opt_all``
(every boolean flag of the reference's optimizations), ``k=v`` (an int
where ``v`` parses as one, else the string) and bare names (True).
Flags are read when the code that takes them runs, so a process sees
the setting of the moment.

What each flag does on one card:

  prob_bf16     — attention probabilities in bf16 for P.V, as the
                  reference's jnp attention route computes them
                  (``repro/kernels/ops.py:36-110``, the route its MLA
                  decode and every prefill whose length its 1024-row
                  block does not divide take): for bf16 operands q
                  scale rounds to bf16, the scores and l = sum p stay
                  float32, and P.V takes p as one bf16 term (flash-
                  attention forward #5 and the dv product of #7 each
                  build a variant for it; the MLA decode attends so in
                  torch).  The backward passes the cast straight
                  through: ds from float32 p, dv from bf16 p.  Float32
                  operands are unchanged, as in the reference.
  ssd_chunk=N   — the SSD chunk of every prefill and training scan (0 =
                  the config's; ``repro/models/ssm.py:113-114``); the
                  kernels take chunks up to 256 and raise above.
  microbatch=N  — gradient accumulation over N microbatches inside the
                  train step (``repro/train/train_step.py:90-127``):
                  where N > 1 divides the batch, ``g_acc + g / N`` from
                  zeros in microbatch order, loss and metrics averaged
                  the same way.
  gqa_grouped   — the layout of the reference's jnp GQA einsums (K and
                  V not repeated to the q heads).  The port's kernels
                  index K and V by kv head already, MLA's group is 1,
                  and the GQA decode does not go through the attention
                  op in either package (``repro/models/layers.py:180-
                  185``): it changes no bit here.
  bf16_experts, moe_3d, dp_over_model, replicate_ff, zero1
                — read only on the reference's mesh paths:
                  ``bf16_experts`` in ``_expert_mlp_any``
                  (``repro/models/moe.py:90-107``), which only the
                  scatter and all-to-all paths call (``:155``,
                  ``:194``; one device runs ``_dense_path``,
                  ``:266-270``); ``moe_3d`` at ``moe.py:238``,
                  ``dp_over_model`` at ``layers.py:82-91``,
                  ``replicate_ff`` and ``zero1`` in the dry-run's step
                  (``launch/dryrun.py:94-99``).  On one card they
                  change nothing in the reference, and nothing here.
                  On a mesh the port reads them all as the reference
                  does: ``dp_over_model`` in ``models.layers.
                  batch_axes_for``, ``replicate_ff`` and ``zero1`` in
                  ``launch.dryrun``'s step, ``bf16_experts`` in
                  ``models.moe.expert_mlp`` and ``moe_3d`` in
                  ``models.moe.MoE``'s mesh dispatch.
  util_engine=NAME — the arc-load engine of ``core.utilization`` calls
                  that name none: auto | dense | fused | orbit.  The
                  reference's names raise where they are used, with the
                  message an ``engine=`` argument gives.
  util_orbits=0 — keeps ``auto`` off the automorphism shortcut (and off
                  the weighted path's uniform-demand rerouting), to
                  measure the exact engines.
  util_dense_max=N — the largest vertex count whose BFS takes the dense
                  (N, N) adjacency (default 6144); a sparse CSR
                  adjacency above.
  util_block=N  — source-block rows of the arc-load sweeps (0 = about
                  48 MB of float64 working set a block).
  sim_backend=NAME — the simulator backend that ``SimConfig(backend=
                  "auto")`` defers to first: auto | dense | fused.
  obs=MODE      — the mode of ``obs.session()`` calls that name none:
                  none | metrics | trace.
  util_jax_max, util_blas_threads, util_workers, sim_workers
                — steer the reference's jax engine, OpenBLAS threads and
                  host worker threads (``repro/core/utilization.py:66-
                  68``, ``:118``, ``:144``; ``repro/sim/kernel.py:602``),
                  which the port does not carry: kept so that a
                  ``REPRO_PERF`` line of the reference parses, read by
                  nothing.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["PerfFlags", "flags", "set_flags", "from_env", "non_default"]


@dataclasses.dataclass
class PerfFlags:
    bf16_experts: bool = False
    gqa_grouped: bool = False
    prob_bf16: bool = False
    microbatch: int = 1
    moe_3d: bool = True
    zero1: bool = False
    dp_over_model: bool = False
    ssd_chunk: int = 0
    replicate_ff: bool = False
    util_engine: str = "auto"
    util_orbits: bool = True
    util_dense_max: int = 6144
    util_jax_max: int = 12288
    util_block: int = 0
    util_blas_threads: int = 1
    util_workers: int = 2
    sim_backend: str = "auto"
    sim_workers: int = 2
    obs: str = "none"


_FLAGS = PerfFlags()


def flags() -> PerfFlags:
    return _FLAGS


def set_flags(**kw) -> PerfFlags:
    for k, v in kw.items():
        if not hasattr(_FLAGS, k):
            raise KeyError(k)
        setattr(_FLAGS, k, v)
    return _FLAGS


def from_env(env: str | None = None) -> PerfFlags:
    """Parse ``REPRO_PERF`` (or ``env``) and apply it."""
    spec = env if env is not None else os.environ.get("REPRO_PERF", "")
    for tok in filter(None, (t.strip() for t in spec.split(","))):
        if tok == "opt_all":
            set_flags(bf16_experts=True, gqa_grouped=True, prob_bf16=True,
                      moe_3d=True)
        elif "=" in tok:
            k, v = tok.split("=", 1)
            try:
                val: int | str = int(v)
            except ValueError:
                val = v
            set_flags(**{k: val})
        else:
            set_flags(**{tok: True})
    return _FLAGS


def non_default() -> dict:
    """The flags that differ from their defaults, by name."""
    default = PerfFlags()
    return {f.name: getattr(_FLAGS, f.name)
            for f in dataclasses.fields(PerfFlags)
            if getattr(_FLAGS, f.name) != getattr(default, f.name)}


from_env()
