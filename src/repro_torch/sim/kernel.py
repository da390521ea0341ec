"""The fused blocked sparse-destination simulator step.

Counterpart of ``repro.sim.kernel._make_step_kernel`` (the reference's
``backend="pallas"`` on a TPU): the step semantics of
:mod:`repro_torch.sim.engine`, restructured around one fused
forward/throttle/enqueue pass per virtual channel over a blocked dest
axis (tiles of :data:`DEST_TILE` destinations), with dead
(router, dest-tile) blocks skipped:

  1. per-slot occupancy and the arrival gather ``arr[h] = sum
     share(a) * q[a]`` over reverse arcs (delivered fluid is the
     extracted ``(router, self-dest)`` column — the deliver mask has at
     most one hit per arc);
  2. the per-hop UGAL decision as one kernel (q_min contraction,
     threshold, candidate mask): :func:`fused_decision`;
  3. the fused update ``q*fac - q*corr*deliver + inflow*split`` plus the
     per-slot post-step occupancy: :func:`fused_step_update`.

Both kernels are hand-written CUDA on the card and their plain versions
on the CPU (:mod:`repro_torch.kernels.sim_step`).  Tile masks are
computed on the device and never read back: the step issues no host
sync.

Destination sparsity is per VC.  Under ugal/valiant the active set stays
whole, but with ``dest_cols`` the final-destination axes — q0, q2, src
and the PEND pool's dest axis — carry only the ``C`` demanded columns
while q1 and stage2 keep the full ``M`` mid axis (:class:`_DestAxis`
holds the remapped index views).  The compaction is exact: diverted
fluid keeps its final destination.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.sim_step import DEST_TILE, fused_decision, fused_step_update
from .engine import _BIG, _TINY, SimConfig, arrival_index, gather_arrivals
from .tables import RouteTables

__all__ = ["make_step_sparse", "step_aux", "resolve_dtype"]


class _StepAux:
    """Arc-level index structure of one RouteTables instance: the
    reverse-arc pairing that turns the arrival scatter into a gather, the
    per-arc dest index of the head router, and the dest tiling.  Built on
    the host from the head table; index tensors live on the tables'
    device."""

    def __init__(self, t: RouteTables, tile: int = DEST_TILE):
        n, k, m = t.n, t.k, t.m
        self.m = m
        self.device = t.device
        nk = n * k
        head_flat = t.head.reshape(-1).cpu().numpy()
        inv_act = np.full(n + 1, m, dtype=np.int64)
        inv_act[t.active.cpu().numpy()] = np.arange(m)
        # dest index of each arc's head (m = not a dest)
        self.dd = inv_act[head_flat]                      # (NK,)
        self_d = inv_act[:n]                              # (N,)
        # reverse-arc pairing from the head table alone (multi-edges are
        # matched in slot order)
        buckets: dict = defaultdict(lambda: ([], []))
        for a in range(nk):
            h = head_flat[a]
            if h >= n:
                continue
            r = a // k
            lo, hi = (r, h) if r <= h else (h, r)
            buckets[(lo, hi)][0 if r <= h else 1].append(a)
        rev = np.full(nk, -1, dtype=np.int64)
        for (lo, hi), (fwd, bwd) in buckets.items():
            if lo == hi:  # self-loop: pair consecutive slots
                for x, y in zip(fwd[0::2], fwd[1::2]):
                    rev[x], rev[y] = y, x
                continue
            if len(fwd) != len(bwd):
                raise ValueError("head table is not symmetric: cannot "
                                 "pair reverse arcs")
            for x, y in zip(fwd, bwd):
                rev[x], rev[y] = y, x
        self.rev_np = rev
        self.rev = torch.as_tensor(rev, device=self.device)  # (NK,)
        real = np.nonzero(rev >= 0)[0]
        # deliver fixup: arcs whose head is a dest
        fr = real[self.dd[real] < m]
        self.fix_arc = fr                                 # (F,) arc flats
        self.fix_dst = self.dd[fr]                        # (F,) dest col
        # delivered extraction: routers that are dests themselves
        hs = np.nonzero(self_d < m)[0]
        self.dst_router = hs                              # (H,)
        self.dst_col = self_d[hs]                         # (H,)
        self.tile = tile


class _DestAxis:
    """One destination-axis view of the blocked state: the full ``M``
    active columns, or compacted to the ``C`` demanded columns.  Entries
    whose dest column is outside the view are dropped — exact, because a
    compacted VC never carries fluid addressed there."""

    def __init__(self, aux: _StepAux, cols=None):
        fix_arc, fix_dst = aux.fix_arc, aux.fix_dst
        dst_router, dst_col = aux.dst_router, aux.dst_col
        if cols is None:
            self.w = aux.m
        else:
            cols = np.asarray(cols, dtype=np.int64)
            pos = np.full(aux.m, -1, dtype=np.int64)
            pos[cols] = np.arange(len(cols))
            self.w = len(cols)
            keep = pos[fix_dst] >= 0
            fix_arc, fix_dst = fix_arc[keep], pos[fix_dst[keep]]
            keep = pos[dst_col] >= 0
            dst_router, dst_col = dst_router[keep], pos[dst_col[keep]]
        dev = aux.device
        self.fix_arc = torch.as_tensor(fix_arc, device=dev)
        self.fix_dst = torch.as_tensor(fix_dst, device=dev)
        self.dst_router = torch.as_tensor(dst_router, device=dev)
        self.dst_col = torch.as_tensor(dst_col, device=dev)
        self.n_tiles = -(-self.w // aux.tile)


def _pool_diag(t: RouteTables, cols):
    """(mid, dest-col) pairs of the compacted PEND pool's self-delivery
    diagonal: pool row ``mid`` meets column ``pos[mid]`` where the mid is
    itself a demanded dest.  ``cols=None`` is the full diagonal."""
    m = t.m
    if cols is None:
        idx = np.arange(m)
        return idx, idx
    pos = np.full(m, -1, dtype=np.int64)
    pos[np.asarray(cols, dtype=np.int64)] = np.arange(len(cols))
    diag_mid = np.nonzero(pos >= 0)[0]
    return diag_mid, pos[diag_mid]


def step_aux(t: RouteTables, tile: int = DEST_TILE) -> _StepAux:
    """The (cached) arc-index structure of one RouteTables instance."""
    aux = getattr(t, "_step_aux", None)
    if aux is None or aux.tile != tile:
        aux = _StepAux(t, tile)
        t._step_aux = aux
    return aux


def resolve_dtype(name: str, backend: str) -> torch.dtype:
    """State dtype for a backend: ``fused`` defaults to float32 (the
    dense float64 step stays its oracle), ``dense`` to float64."""
    if name == "auto":
        return torch.float32 if backend == "fused" else torch.float64
    if name in ("f32", "float32"):
        return torch.float32
    if name in ("f64", "float64"):
        return torch.float64
    raise ValueError(f"unknown sim dtype {name!r}; options: auto, "
                     "float32, float64")


def make_step_sparse(t: RouteTables, cfg: SimConfig, dtype,
                     dest_cols=None):
    """Build the fused ``step(state, inj, inj_cap)``.  Same contract as
    :func:`repro_torch.sim.engine.make_step`; ``dest_cols`` carries the
    per-VC compacted dest axis (q0/q2/src/pend-dest on those columns,
    q1/stage2 on the full mid axis).

    Under an obs session the build is counted by route, as the
    reference counts its pallas-vs-numpy dispatch:
    ``sim.step_build[fused_cuda]`` where the tables lie on the card (the
    step launches the CUDA kernels), ``sim.step_build[fused_plain]`` on
    the CPU (their plain versions), and ``sim.step_build[fused_decision]``
    for a ugal step, whose decision runs fused.  The reference's
    ``sim.slab_waves`` / ``sim.slab_wave_seconds`` have no counterpart:
    the port has no threaded host slabs."""
    from .. import obs
    if cfg.mode == "ugal":
        obs.counter("sim.step_build[fused_decision]").add(1.0)
    obs.counter("sim.step_build[fused_cuda]" if t.device.type == "cuda"
                else "sim.step_build[fused_plain]").add(1.0)
    aux = step_aux(t)
    dev = t.device
    n, k, m = t.n, t.k, t.m
    nk = n * k
    tile = aux.tile
    axF = _DestAxis(aux)
    axC = _DestAxis(aux, dest_cols) if dest_cols is not None else axF
    ax = (axC, axF, axC)
    widths = tuple(a.w for a in ax)

    def asd(a):
        return a.to(dtype).contiguous()
    split3F = asd(t.split)
    # deliver stays a dtype plane, as in the reference: at PN(27) it costs
    # 256.7 MB (full) + 128 MB (compacted) in float32 and one stream per
    # kernel launch; deriving it from _StepAux.dd is later perf work
    deliverF = asd(t.deliver)
    if dest_cols is not None:
        csel = torch.as_tensor(np.asarray(dest_cols, dtype=np.int64),
                               device=dev)
        split3C = asd(t.split[:, :, csel])
        deliverC = asd(t.deliver[:, :, csel])
        dist_c = asd(t.dist_act[:, csel])
        hval_c = asd(t.hval_rem[:, csel])
    else:
        split3C, deliverC = split3F, deliverF
        dist_c = asd(t.dist_act)
        hval_c = asd(t.hval_rem)
    split3_v = (split3C, split3F, split3C)
    deliver_v = (deliverC, deliverF, deliverC)
    diag_mid, diag_col = (torch.as_tensor(x, device=dev)
                          for x in _pool_diag(t, dest_cols))
    spread = asd(t.spread)
    # faulted tables (dead slots: split 0; unroutable pairs: dist and
    # hval 0) run the same kernels; only the pend update changes, since
    # a faulted spread is not uniform
    faulted = t.faulted
    spread_T = spread.T.contiguous() if faulted else None   # (M, N)
    w_val = torch.einsum("nm,nkm->nk", spread, split3F).reshape(nk)
    in_active = torch.zeros(n, dtype=torch.bool, device=dev)
    in_active[t.active] = True
    n_mids = (m - in_active.to(torch.int64)).to(dtype)
    active = t.active
    head_flat = t.head.reshape(-1)
    rev_idx = arrival_index(aux.rev, nk)
    mode, thr = cfg.mode, cfg.threshold
    cap = float(cfg.capacity)
    cap_t = torch.tensor(cap, dtype=dtype, device=dev)
    buf = float(min(cfg.buffer, _BIG))
    one = torch.ones(1, dtype=dtype, device=dev)

    def tile_sums(x, v):                     # (W_v,) -> (T_v,)
        pad = ax[v].n_tiles * tile - widths[v]
        return F.pad(x, (0, pad)).reshape(ax[v].n_tiles, tile).sum(-1)

    def step(state, inj, inj_cap):
        q0, q1, q2, src, pend, stage2 = state
        qs = (q0, q1, q2)
        o = [q.reshape(nk, widths[v]).sum(dim=1) for v, q in enumerate(qs)]
        share = cap_t / (o[0] + o[1] + o[2]).clamp(min=cap)   # (NK,)

        arr, dl_sum, damp = [], [], []
        stage2_new = stage2
        for v, q in enumerate(qs):
            axis = ax[v]
            a = gather_arrivals(q.reshape(nk, axis.w) * share[:, None],
                                rev_idx, n, k)
            dl = a[axis.dst_router, axis.dst_col]
            if v == 1:
                stage2_new = stage2.clone()
                stage2_new[axis.dst_col] += dl        # dst_col is unique
            dl_sum.append(dl.sum())
            a[axis.dst_router, axis.dst_col] = 0.0    # transit arrivals
            own = (o[v] * (1.0 - share)).reshape(n, k).sum(dim=1)
            space = (buf - own).clamp(min=0.0)
            desire = a.sum(dim=1)
            s = (space / desire.clamp(min=_TINY)).clamp(max=1.0)
            damp.append(torch.cat([s, one])[head_flat])
            arr.append(a * s[:, None])

        delivered = dl_sum[0] + dl_sum[2]
        stage2 = stage2_new

        def rowfwd(v):
            # post-forward per-router occupancy, without touching q:
            # retention of o minus the delivered fluid's extra share.
            # Hazard: fix_router repeats, so the reference's scatter-add
            # by router would be a float atomic on CUDA; the values go to
            # the unique fix_arc instead and each router sums its slots.
            axis = ax[v]
            f = (o[v] * (1.0 - share * damp[v])).reshape(n, k).sum(dim=1)
            vals = qs[v].reshape(nk, axis.w)[axis.fix_arc, axis.fix_dst]
            fx = vals * share[axis.fix_arc] * (1.0 - damp[v][axis.fix_arc])
            per_arc = torch.zeros(nk, dtype=dtype, device=dev)
            per_arc[axis.fix_arc] = fx
            return f - per_arc.reshape(n, k).sum(dim=1)

        # -- conversions ----------------------------------------------
        occ2_now = rowfwd(2) + arr[2].sum(dim=1)
        avail2 = (buf - occ2_now).clamp(min=0.0)[active]
        # hazard: a PEND row sum can round below zero at finite-buffer
        # overload; the reference's drain then goes negative and the
        # occupancy to inf/NaN.  Clamped at 0 here.
        pend_sum = pend.sum(dim=1).clamp(min=0.0)
        drain = torch.minimum(torch.minimum(stage2, avail2), pend_sum)
        mix = pend / pend_sum.clamp(min=_TINY)[:, None]
        take = drain[:, None] * mix                # (M, C)
        pend = pend - take
        stage2 = stage2 - drain
        delivered = delivered + take[diag_mid, diag_col].sum()
        take[diag_mid, diag_col] = 0.0
        conv2 = torch.zeros((n, widths[2]), dtype=dtype, device=dev)
        conv2[active] = take                       # active is unique

        # -- injection -------------------------------------------------
        src = src + inj
        srcsum = src.sum(dim=1)
        frac = torch.minimum(srcsum, inj_cap) / srcsum.clamp(min=_TINY)
        q_inj = src * frac[:, None]
        src = src - q_inj

        # -- decision (fused kernel: q_min + threshold + mask) ---------
        cand = arr[0] + q_inj
        if mode == "minimal":
            div_eff = torch.zeros_like(cand)
        else:
            if mode == "valiant":
                div_cand = cand
            else:
                b0 = (o[0] - cap).clamp(min=0.0).reshape(n, k)
                b1 = (o[1] - cap).clamp(min=0.0)
                q_val = (b1 * w_val).reshape(n, k).sum(dim=1)
                ctm = tile_sums(cand.sum(dim=0), 0)
                div_cand = fused_decision(
                    b0, split3_v[0], dist_c, hval_c, cand, q_val,
                    (ctm > 0).to(torch.int32), thr)
            occ1_now = rowfwd(1) + arr[1].sum(dim=1)
            space1 = (buf - occ1_now).clamp(min=0.0)
            desire1 = div_cand.sum(dim=1)
            s1d = (space1 / desire1.clamp(min=_TINY)).clamp(max=1.0)
            div_eff = div_cand * s1d[:, None]
            if faulted:
                # the reference forms this product outside its kernels
                pend = pend + spread_T @ div_eff
            else:
                scaled = div_eff / n_mids[:, None]
                pend = pend + scaled.sum(0)[None, :] - scaled[active, :]

        keep = cand - div_eff
        keep_frac = keep / cand.clamp(min=_TINY)
        trans_keep = arr[0] * keep_frac
        inj_keep = q_inj * keep_frac
        occ0_now = rowfwd(0) + trans_keep.sum(dim=1)
        space0 = (buf - occ0_now).clamp(min=0.0)
        desire0 = inj_keep.sum(dim=1)
        s0i = (space0 / desire0.clamp(min=_TINY)).clamp(max=1.0)
        inj_adm = inj_keep * s0i[:, None]
        src = src + (inj_keep - inj_adm)

        inflow = [trans_keep + inj_adm,
                  arr[1] + div_eff.sum(dim=1)[:, None] * spread,
                  arr[2] + conv2]

        # -- fused kernel: forward + throttle retention + enqueue ------
        occ = stage2.sum()
        new_qs = []
        for v in range(3):
            fac2 = (1.0 - share * damp[v]).reshape(n, k)
            corr2 = (share * (1.0 - damp[v])).reshape(n, k)
            mass = tile_sums(qs[v].reshape(nk, widths[v]).sum(dim=0)
                             + inflow[v].sum(dim=0), v)
            qn, on = fused_step_update(qs[v], split3_v[v], deliver_v[v],
                                       fac2, corr2, inflow[v],
                                       (mass > 0).to(torch.int32))
            occ = occ + on.sum()
            new_qs.append(qn)

        accepted = q_inj.sum() - (inj_keep - inj_adm).sum()
        stats = torch.stack([delivered, accepted, inj.sum(), occ,
                             src.sum(), div_eff.sum()])
        return (new_qs[0], new_qs[1], new_qs[2], src, pend, stage2), stats

    return step
