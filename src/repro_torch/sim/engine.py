"""The simulator's configuration, state and dense step.

Counterpart of ``repro.sim.engine``.  Model (full semantics in
``docs/simulation.md``):

* Fluid flow at one-hop-per-step granularity in per-arc output queues
  ``Q[router, out-slot, dest]``, one tensor per virtual channel: vc0
  carries minimal-mode traffic, vc1 the first Valiant leg (routing dest
  = the intermediate), vc2 the second leg.
* Each arc forwards up to ``capacity`` flits per step, shared
  proportionally across (vc, dest).  Arriving fluid is ejected at its
  routing dest, otherwise re-enqueued through the equal-split minimal
  table (per-hop ECMP).
* Credit-based finite buffers: a router's per-vc occupancy may not
  exceed ``buffer``; blocked transit stays upstream, blocked injections
  stay in the source backlog, blocked diversions continue minimally.
* Per-hop threshold UGAL: a vc0 enqueue at r toward d diverts to vc1 iff
  ``dist(r, d) * q_min > T + hval(r, d) * q_val``; diverted fluid spreads
  over the active intermediates, and the (intermediate, dest) pairing of
  phase-1 fluid lives in the aggregate ``PEND`` pool.

:func:`make_step` is the dense step (``backend="dense"``, the reference's
``numpy``/``jax`` step), float64 by default: the on-card oracle of the
fused step of :mod:`repro_torch.sim.kernel`.  Its einsum and its
matrix products run in full precision on the card:
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's
default), since TF32 keeps three decimal digits and the threshold rule
would amplify that.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch

from .tables import RouteTables

__all__ = ["SimConfig", "SimState", "make_step", "init_state",
           "parse_sim_routing", "pick_backend", "BACKENDS", "STAT_NAMES",
           "SIM_MAX_CELLS"]

_BIG = 1e12     # unreachable-queue sentinel for masked mins
_TINY = 1e-30   # safe-division floor

# Dense-backend ceiling on (router, slot, dest) cells: above it ``auto``
# takes the fused blocked step and an explicit ``dense`` is refused.
SIM_MAX_CELLS = 50_000_000

BACKENDS = ("auto", "dense", "fused")

_SIM_SPEC_RE = re.compile(
    r"^\s*(minimal|valiant|ugal|ugal_threshold)\s*(?:\(\s*([^)]*)\s*\))?\s*$")

# stats vector layout emitted by one step
STAT_NAMES = ("delivered", "accepted", "offered", "occupancy",
              "src_backlog", "diverted")


def parse_sim_routing(spec) -> tuple[str, float]:
    """``(mode, threshold)`` from a simulator routing spec: ``minimal``,
    ``valiant``, ``ugal_threshold(T)``, or ``ugal`` (= threshold 0)."""
    m = _SIM_SPEC_RE.match(str(spec))
    if not m:
        raise ValueError(
            f"unknown sim routing {spec!r}; options: minimal, valiant, "
            f"ugal, ugal_threshold(T)")
    name, arg = m.group(1), m.group(2)
    if name in ("minimal", "valiant"):
        if arg:
            raise ValueError(f"{name} takes no argument, got {spec!r}")
        return name, 0.0
    t = float(arg) if arg else 0.0
    if not t >= 0:  # also rejects nan
        raise ValueError(f"threshold must be >= 0, got {t}")
    return "ugal", t


@dataclass(frozen=True)
class SimConfig:
    """Knobs of one simulation run.

    ``routing`` is a simulator spec (:func:`parse_sim_routing`);
    ``buffer`` the per-(router, vc) occupancy limit in flit units
    (``inf`` = the fluid limit); ``capacity`` the per-arc flits/step;
    ``inj_factor`` caps the per-step source drain at ``inj_factor`` times
    the offered quantum.

    ``backend`` maps onto the reference's backends:

      * ``dense`` — the reference's ``numpy``/``jax`` dense step;
      * ``fused`` — the reference's ``pallas``: the blocked sparse-dest
        step whose two kernels are hand-written CUDA on the card (their
        plain versions on the CPU);
      * ``auto`` — the reference rule: ``fused`` above
        :data:`SIM_MAX_CELLS` dense cells, ``dense`` otherwise.

    ``dtype`` is ``auto`` (float32 for ``fused``, float64 for ``dense``),
    ``float32`` or ``float64``; ``compact`` gates static dest compaction
    against the run's demand (``auto`` or ``off``)."""

    routing: str = "minimal"
    buffer: float = float("inf")
    capacity: float = 1.0
    inj_factor: float = 1.0
    backend: str = "auto"
    dtype: str = "auto"
    compact: str = "auto"

    @property
    def mode(self) -> str:
        return parse_sim_routing(self.routing)[0]

    @property
    def threshold(self) -> float:
        return parse_sim_routing(self.routing)[1]


@dataclass
class SimState:
    """All mutable fluid of one run, as tensors on the run's device."""

    q0: torch.Tensor = field(repr=False)      # (N, K, C) minimal queues
    q1: torch.Tensor = field(repr=False)      # (N, K, M) Valiant leg 1
    q2: torch.Tensor = field(repr=False)      # (N, K, C) Valiant leg 2
    src: torch.Tensor = field(repr=False)     # (N, C) source backlog
    pend: torch.Tensor = field(repr=False)    # (M, C) (mid, dest) pool
    stage2: torch.Tensor = field(repr=False)  # (M,) converted, waiting

    def as_tuple(self):
        return (self.q0, self.q1, self.q2, self.src, self.pend, self.stage2)


def pick_backend(backend: str, work: int) -> str:
    """Resolve ``auto`` against the dense cell cap and validate explicit
    choices.  ``auto`` first defers to the ``sim_backend`` perf flag
    (``REPRO_PERF=sim_backend=dense|fused``), as in the reference."""
    if backend == "auto":
        from ..perf import flags
        backend = flags().sim_backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown sim backend {backend!r}; options: "
                         f"{', '.join(BACKENDS)}")
    if backend == "auto":
        return "fused" if work > SIM_MAX_CELLS else "dense"
    return backend


def init_state(t: RouteTables, dtype, dest_cols=None) -> SimState:
    """Zero fluid state for ``t`` on the tables' device.  With
    ``dest_cols`` (the fused step's per-VC compacted dest axis) q0, q2,
    src and the pend pool's dest axis carry only the ``C`` demanded
    columns; q1 and stage2 keep the full ``M`` mid axis."""
    n, k, m = t.n, t.k, t.m
    c = m if dest_cols is None else len(dest_cols)

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=t.device)
    return SimState(q0=z(n, k, c), q1=z(n, k, m), q2=z(n, k, c),
                    src=z(n, c), pend=z(m, c), stage2=z(m))


def arrival_index(rev, nk: int) -> torch.Tensor:
    """(N*K,) gather index of the arrival sum: slot ``(h, k)`` reads its
    reverse arc, padded slots the appended zero row ``nk``."""
    return torch.where(rev >= 0, rev, torch.full_like(rev, nk))


def gather_arrivals(x, rev_idx, n: int, k: int) -> torch.Tensor:
    """``arr[h] = sum over h's in-arcs a of x[a]`` for an (N*K, W) plane.

    Hazard: the reference scatters by head router (``np.add.at`` /
    ``.at[].add``), which on CUDA is a float atomic add in no fixed order.
    Router h's in-arcs are the reverse arcs of its own out-slots, so the
    same sum is a gather over ``rev`` plus a reduction over K: bitwise
    reproducible."""
    w = x.shape[-1]
    ext = torch.cat([x, x.new_zeros((1, w))])
    return ext.index_select(0, rev_idx).reshape(n, k, w).sum(dim=1)


def make_step(t: RouteTables, cfg: SimConfig, dtype):
    """Build the dense ``step(state, inj, inj_cap) -> (state, stats)``.
    ``inj`` is the (N, M) per-step offered quantum and ``inj_cap`` the
    (N,) per-source drain limit, both tensors on the tables' device;
    ``stats`` is a (6,) tensor laid out as :data:`STAT_NAMES`.  Counted
    as ``sim.step_build[dense]`` under an obs session."""
    from .. import obs
    from .kernel import step_aux
    obs.counter("sim.step_build[dense]").add(1.0)
    aux = step_aux(t)
    dev = t.device
    n, k, m = t.n, t.k, t.m
    nk = n * k

    def asd(a):
        return a.to(dtype).contiguous()
    split = asd(t.split)
    deliver = asd(t.deliver)
    spread = asd(t.spread)
    # expected first-hop slot usage of freshly diverted fluid
    w_val = torch.einsum("nm,nkm->nk", spread, split)
    dist_act = asd(t.dist_act)
    hval_rem = asd(t.hval_rem)
    head_flat = t.head.reshape(-1)
    active = t.active
    rev_idx = arrival_index(aux.rev, nk)
    # mids available to a diverting router: m - 1 inside the active set,
    # all m from a transit-only router
    in_active = torch.zeros(n, dtype=torch.bool, device=dev)
    in_active[active] = True
    n_mids = (m - in_active.to(torch.int64)).to(dtype)
    # faulted tables break the uniform spread that the cheap pend update
    # below relies on; they take the general contraction
    faulted = t.faulted
    spread_T = spread.T.contiguous() if faulted else None   # (M, N)
    mode, thr = cfg.mode, cfg.threshold
    cap = float(cfg.capacity)
    cap_t = torch.tensor(cap, dtype=dtype, device=dev)
    buf = float(min(cfg.buffer, _BIG))
    one = torch.ones(1, dtype=dtype, device=dev)
    diag = torch.arange(m, device=dev)

    def throttle(q, mv, arr):
        own = q.sum(dim=(1, 2)) - mv.sum(dim=(1, 2))
        space = (buf - own).clamp(min=0.0)
        desire = arr.sum(-1)
        return (space / desire.clamp(min=_TINY)).clamp(max=1.0)

    def step(state, inj, inj_cap):
        q0, q1, q2, src, pend, stage2 = state

        # -- start-of-step backlog: what the credit/decision logic sees --
        o0 = q0.sum(-1)
        o1 = q1.sum(-1)
        o2 = q2.sum(-1)

        # -- forward: proportional share of each arc's capacity ----------
        share = cap_t / (o0 + o1 + o2).clamp(min=cap)
        mv0 = q0 * share[:, :, None]
        mv1 = q1 * share[:, :, None]
        mv2 = q2 * share[:, :, None]
        del0 = mv0 * deliver
        del1 = mv1 * deliver
        del2 = mv2 * deliver
        cont0 = mv0 - del0
        cont1 = mv1 - del1
        cont2 = mv2 - del2

        # -- credits: continuing arrivals need space at the head ---------
        arr0 = gather_arrivals(cont0.reshape(nk, m), rev_idx, n, k)
        arr1 = gather_arrivals(cont1.reshape(nk, m), rev_idx, n, k)
        arr2 = gather_arrivals(cont2.reshape(nk, m), rev_idx, n, k)
        s0 = throttle(q0, mv0, arr0)
        s1v = throttle(q1, mv1, arr1)
        s2 = throttle(q2, mv2, arr2)
        damp0 = torch.cat([s0, one])[head_flat].reshape(n, k)
        damp1 = torch.cat([s1v, one])[head_flat].reshape(n, k)
        damp2 = torch.cat([s2, one])[head_flat].reshape(n, k)
        q0 = q0 - del0 - cont0 * damp0[:, :, None]   # blocked fluid stays
        q1 = q1 - del1 - cont1 * damp1[:, :, None]
        q2 = q2 - del2 - cont2 * damp2[:, :, None]
        arr0 = arr0 * s0[:, None]
        arr1 = arr1 * s1v[:, None]
        arr2 = arr2 * s2[:, None]

        delivered = del0.sum() + del2.sum()

        # -- phase-1 conversions: intermediate reached, draw final dests -
        stage2 = stage2 + del1.sum(dim=(0, 1))
        occ2_now = q2.sum(dim=(1, 2)) + arr2.sum(-1)
        avail2 = (buf - occ2_now).clamp(min=0.0)[active]
        # hazard: a PEND row sum can round below zero (-1.4e-20) at
        # finite-buffer overload, which makes drain negative and blows
        # occupancy up to inf/NaN in the reference; clamped at 0 here
        pend_sum = pend.sum(-1).clamp(min=0.0)
        drain = torch.minimum(torch.minimum(stage2, avail2), pend_sum)
        mix = pend / pend_sum.clamp(min=_TINY)[:, None]
        take = drain[:, None] * mix
        pend = pend - take
        stage2 = stage2 - drain
        # a conversion whose intermediate IS the destination is delivered
        delivered = delivered + take[diag, diag].sum()
        take[diag, diag] = 0.0
        conv2 = torch.zeros((n, m), dtype=dtype, device=dev)
        conv2[active] = take                          # active is unique

        # -- injection: drain the backlog up to the per-step cap ---------
        src = src + inj
        srcsum = src.sum(-1)
        frac = torch.minimum(srcsum, inj_cap) / srcsum.clamp(min=_TINY)
        q_inj = src * frac[:, None]
        src = src - q_inj

        # -- routing decision on every vc0 enqueue (per-hop UGAL) --------
        cand = arr0 + q_inj
        if mode == "minimal":
            div_eff = torch.zeros_like(cand)
        else:
            if mode == "valiant":
                div_ind = torch.ones_like(cand)
            else:
                b0 = (o0 - cap).clamp(min=0.0)
                b1 = (o1 - cap).clamp(min=0.0)
                q_min = torch.einsum("nk,nkm->nm", b0, split)
                q_val = (b1 * w_val).sum(dim=1)
                div_ind = (dist_act * q_min
                           > thr + hval_rem * q_val[:, None]).to(dtype)
            div_cand = cand * div_ind
            occ1_now = q1.sum(dim=(1, 2)) + arr1.sum(-1)
            space1 = (buf - occ1_now).clamp(min=0.0)
            desire1 = div_cand.sum(-1)
            s1d = (space1 / desire1.clamp(min=_TINY)).clamp(max=1.0)
            div_eff = div_cand * s1d[:, None]         # blocked stays vc0
            # pend += spread.T @ div_eff, expanded to O(N * M) via the
            # uniform spread[r, m] = (1 - [active[m] == r]) / n_mids[r];
            # a faulted spread is not uniform: the product itself
            if faulted:
                pend = pend + spread_T @ div_eff
            else:
                scaled = div_eff / n_mids[:, None]
                pend = pend + scaled.sum(0)[None, :] - scaled[active, :]

        keep = cand - div_eff
        keep_frac = keep / cand.clamp(min=_TINY)
        trans_keep = arr0 * keep_frac
        inj_keep = q_inj * keep_frac
        occ0_now = q0.sum(dim=(1, 2)) + trans_keep.sum(-1)
        space0 = (buf - occ0_now).clamp(min=0.0)
        desire0 = inj_keep.sum(-1)
        s0i = (space0 / desire0.clamp(min=_TINY)).clamp(max=1.0)
        inj_adm = inj_keep * s0i[:, None]
        src = src + (inj_keep - inj_adm)

        # -- enqueue through the equal-split minimal table ---------------
        inflow0 = trans_keep + inj_adm
        inflow1 = arr1 + div_eff.sum(-1)[:, None] * spread
        inflow2 = arr2 + conv2
        q0 = q0 + inflow0[:, None, :] * split
        q1 = q1 + inflow1[:, None, :] * split
        q2 = q2 + inflow2[:, None, :] * split

        occ = q0.sum() + q1.sum() + q2.sum() + stage2.sum()
        accepted = q_inj.sum() - (inj_keep - inj_adm).sum()
        stats = torch.stack([delivered, accepted, inj.sum(), occ,
                             src.sum(), div_eff.sum()])
        return (q0, q1, q2, src, pend, stage2), stats

    return step
