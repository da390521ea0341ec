"""Plain PyTorch versions of the port's kernels.

Same functions as the CUDA kernels of ``csrc/*.cu``, written as ordinary
tensor algebra (formulas: ``repro/kernels/sim_step.py``,
``mask_gemm.py``, ``flash_attention.py`` (forward and backward) and
``ssd_scan.py``).  The
kernel wrappers of :mod:`repro_torch.kernels` run these for CPU tensors;
tests and ``chip_smoke.py`` hold the CUDA kernels against them on the
card.  Nothing on the main path uses them when a card is present, except
the mask epilogues, which the analytic ``dense`` engine shares.

``attention_ref`` and ``ssd_ref`` are the oracles of the model kernels,
as in the reference: masked softmax attention in one piece, and the SSD
as its exact sequential recurrence.  ``ssd_scan_chunked_ref`` mirrors the
three phases of the bf16 SSD kernels, and ``ssd_scan_bwd_ref`` is its
backward, written by hand.  The ``terms`` options of
``ssd_scan_chunked_ref`` and of ``flash_attention_ref`` emulate how the tensor-core kernels multiply a
float32 operand (tests and ``chip_smoke.py`` only).  Under the
``prob_bf16`` perf flag the attention kernels' plain versions take p as
one bf16 term for P.V (:func:`attention_prob_bf16_ref`, the reference's
jnp route under that flag).  ``moe_dense_ref``
is the oracle of the MoE block's route (the reference's ``_dense_path``),
which has no kernel.
"""

from __future__ import annotations

import torch

__all__ = ["fused_step_update_ref", "fused_decision_ref", "tile_live",
           "dense_from_csc", "frontier_epilogue", "backward_epilogue",
           "frontier_step_ref", "backward_step_ref", "masked_product_tiled",
           "frontier_step_tiled_ref", "backward_step_tiled_ref",
           "flash_attention_ref", "attention_prob_bf16_ref",
           "flash_attention_dq_ref", "flash_attention_dkv_ref",
           "flash_attention_bwd_ref", "bf16_split3", "split_matmul",
           "ssd_scan_ref", "ssd_scan_chunked_ref", "ssd_scan_bwd_ref",
           "attention_ref",
           "ssd_ref", "moe_dense_ref", "NEG_INF"]

DEST_TILE = 128


def tile_live(tile_mask: torch.Tensor, width: int,
              tile: int = DEST_TILE) -> torch.Tensor:
    """(width,) bool: the column lies in a tile whose mask is nonzero."""
    return (tile_mask != 0).repeat_interleave(tile)[:width]


def fused_step_update_ref(q, split, deliver, fac, corr, inflow, tile_mask):
    """``(q_out, o_out)`` of one VC's fused forward/throttle/enqueue:
    ``q*fac - q*corr*deliver + inflow*split`` on live dest tiles, zero on
    dead ones, and ``o_out = q_out.sum(-1)``."""
    upd = q * fac[:, :, None]
    upd = upd - q * corr[:, :, None] * deliver
    upd = upd + inflow[:, None, :] * split
    live = tile_live(tile_mask, q.shape[-1])
    q_out = torch.where(live, upd, torch.zeros((), dtype=q.dtype,
                                               device=q.device))
    return q_out, q_out.sum(-1)


def fused_decision_ref(b0, split, dist, hval, cand, q_val, tile_mask,
                       thr: float):
    """Diverting candidate fluid of the per-hop UGAL rule: ``cand`` where
    ``dist * q_min > thr + hval * q_val`` with ``q_min = sum_k b0 *
    split``, zero elsewhere and on dead tiles."""
    q_min = (b0[:, :, None] * split).sum(dim=1)
    divert = dist * q_min > thr + hval * q_val[:, None]
    live = tile_live(tile_mask, split.shape[-1])
    return torch.where(divert & live, cand,
                       torch.zeros((), dtype=cand.dtype, device=cand.device))


def dense_from_csc(indptr, indices, data) -> torch.Tensor:
    """The dense (N, N) matrix of a compressed-column triple: column v
    holds ``data[indptr[v]:indptr[v+1]]`` at rows ``indices[...]``
    (repeated entries add)."""
    n = indptr.numel() - 1
    cols = torch.repeat_interleave(
        torch.arange(n, device=data.device), (indptr[1:] - indptr[:-1]).long())
    a = torch.zeros((n, n), dtype=data.dtype, device=data.device)
    a.index_put_((indices.long(), cols), data, accumulate=True)
    return a


def frontier_epilogue(t, dist, sigma, lvl: int):
    """Mask epilogue of one forward BFS level on ``t = front @ A``:
    ``(nxt, dist', sigma', any_new)`` with ``new = (t > 0) & (dist < 0)``,
    ``nxt = t * new``, ``dist' = where(new, lvl, dist)``, ``sigma' =
    where(new, t, sigma)`` and ``any_new`` an int32 scalar tensor, 1 iff
    some vertex was claimed."""
    new = (t > 0) & (dist < 0)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    nxt = torch.where(new, t, zero)
    dist_out = torch.where(new, torch.full((), lvl, dtype=dist.dtype,
                                           device=dist.device), dist)
    return (nxt, dist_out, torch.where(new, t, sigma),
            new.any().to(torch.int32))


def backward_epilogue(t, dist, sigma, delta, lvl: int):
    """Mask epilogue of one backward dependency level on ``t = coeff @
    A``: ``delta + sigma * (t * (dist == lvl))``."""
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return delta + sigma * torch.where(dist == lvl, t, zero)


def frontier_step_ref(front, adj, dist, sigma, lvl: int):
    """Plain version of the forward mask+GEMM kernel: a dense product
    with A rebuilt from its compressed-column triple ``adj``, then
    :func:`frontier_epilogue`."""
    return frontier_epilogue(front @ dense_from_csc(*adj), dist, sigma, lvl)


def backward_step_ref(coeff, adj, dist, sigma, delta, lvl: int):
    """Plain version of the backward mask+GEMM kernel: a dense product
    with A rebuilt from its compressed-column triple ``adj``, then
    :func:`backward_epilogue`."""
    return backward_epilogue(coeff @ dense_from_csc(*adj), dist, sigma,
                             delta, lvl)


def masked_product_tiled(x, adj, need, *, chunk: int, lanes: int = 16):
    """``where(need, x @ A, 0)`` with A the compressed-column triple
    ``adj``, summed as the kernels of ``csrc/mask_gemm.cu`` sum it, bit
    for bit: the contraction in chunks of ``chunk`` consecutive rows u of
    A (``chunk >= N``: one chunk); in each chunk lane l of a column's
    ``lanes`` takes the column's entries beg + l, beg + l + lanes, ...
    whose row lies in the chunk, in turn, each product and sum rounded by
    itself; an xor tree closes the lanes' sums (lane l adds lane
    l ^ lanes/2, then l ^ lanes/4, ..., l ^ 1: halves added pairwise in
    turn), and the chunks' sums add in chunk order.
    Outputs outside ``need`` are never summed (0 here)."""
    indptr, indices, data = adj
    s, n = x.shape
    beg, end = indptr[:-1].long(), indptr[1:].long()
    steps = -(-int((end - beg).max()) // lanes) if n else 0
    lane = torch.arange(lanes, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    t = torch.zeros((s, n), dtype=x.dtype, device=x.device)
    for k0 in range(0, n, chunk):
        part = torch.zeros((s, n, lanes), dtype=x.dtype, device=x.device)
        for step in range(steps):
            j = beg[:, None] + step * lanes + lane            # (N, lanes)
            valid = j < end[:, None]
            j = torch.where(valid, j, 0)
            u = indices[j].long()
            ok = valid & (u >= k0) & (u < min(k0 + chunk, n))
            prod = x[:, u.clamp(0, n - 1)] * data[j]          # no FMA
            part = torch.where(ok, part + prod, part)
        while part.shape[-1] > 1:
            half = part.shape[-1] // 2
            part = part[..., :half] + part[..., half:]
        t = part[..., 0] if k0 == 0 else t + part[..., 0]
    return torch.where(need, t, zero)


def frontier_step_tiled_ref(front, adj, dist, sigma, lvl: int, *,
                            chunk: int, lanes: int = 16):
    """The forward mask+GEMM kernel's outputs bit for bit: the product
    of :func:`masked_product_tiled` where ``dist < 0``, then
    :func:`frontier_epilogue`."""
    t = masked_product_tiled(front, adj, dist < 0, chunk=chunk, lanes=lanes)
    return frontier_epilogue(t, dist, sigma, lvl)


def backward_step_tiled_ref(coeff, adj, dist, sigma, delta, lvl: int, *,
                            chunk: int, lanes: int = 16):
    """The backward mask+GEMM kernel's output bit for bit: the product of
    :func:`masked_product_tiled` where ``dist == lvl``, then
    :func:`backward_epilogue`."""
    t = masked_product_tiled(coeff, adj, dist == lvl, chunk=chunk,
                             lanes=lanes)
    return backward_epilogue(t, dist, sigma, delta, lvl)


# ---------------------------------------------------------------------------
# Model kernels: flash-attention forward and the SSD chunked scan
# ---------------------------------------------------------------------------

NEG_INF = -1e30  # the kernels' mask value (finite, as in the reference)


def _attention_mask(q_pos, k_pos, causal: bool, window):
    mask = torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_prob_bf16_ref(q, k, v, *, causal: bool = True, window=None,
                            q_offset: int = 0, kv_len=None, scale=None):
    """``(o, lse)`` of the reference's jnp attention route under the
    ``prob_bf16`` flag (``_attention_jnp_blocked``) for bf16 operands, in
    one piece: q scale rounded to bf16; scores, the row max m, ``p =
    exp(s - m)`` (0 where masked) and ``l = sum p`` in float32; P.V from
    p rounded to bf16 (to nearest) with float32 sums; then ``o / l``.
    Shapes and masks as :func:`flash_attention_ref`, ``kv_len`` (B,) as
    :func:`attention_ref`; ``o`` in q's dtype (0 on a row with no live
    key), ``lse = m + log(max(l, 1e-30))`` (B, Hq, Sq, 1) float32.  Under
    autograd the two casts pass the gradient straight through, as jax's
    VJP of ``astype`` does: ds from float32 p, dv from bf16 p."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qs = (q.float() * scale).bfloat16().float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = _attention_mask(q_pos, k_pos, causal, window).expand(
        b, hq, sq, skv)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=q.device).reshape(b, 1, 1, 1)
        mask = mask & (k_pos < kl)
    s = torch.where(mask, qs @ kf.transpose(-1, -2), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = (p.bfloat16().float() @ vf) / torch.where(l == 0.0, 1.0, l)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return o.to(q.dtype), lse


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        q_offset: int = 0, scale=None, block_k: int = 64,
                        p_terms=None, prob_bf16: bool = False):
    """``(o, lse)`` of the flash-attention forward: float32 online softmax
    over kv tiles of ``block_k`` keys, masked with -1e30.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), Hq % Hkv == 0; query row i
    sits at position ``q_offset + i``, key j at j.  Any Sq and Skv.
    ``o`` (B, Hq, Sq, D) in q's dtype, 0 on a row with no live key;
    ``lse`` (B, Hq, Sq, 1) float32, ``m + log(max(l, 1e-30))``.
    ``p_terms`` (3 or 1) multiplies p by V as that many bf16 terms (see
    :func:`split_matmul`); None, the plain version, in float32.
    ``prob_bf16`` with bf16 operands: :func:`attention_prob_bf16_ref`
    (float32 operands ignore it, as in the reference).
    """
    if prob_bf16 and q.dtype == torch.bfloat16:
        return attention_prob_bf16_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, scale=scale)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    for k0 in range(0, skv, block_k):
        k_pos = torch.arange(k0, min(k0 + block_k, skv), device=q.device)
        mask = _attention_mask(q_pos, k_pos, causal, window)
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new) * mask
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + split_matmul(p, vf[:, :, k0:k0 + block_k],
                                         p_terms, split_a=True)
        m = m_new
    o = acc / torch.where(l == 0.0, 1.0, l)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return o.to(q.dtype), lse


def _bwd_tiles(q, k, v, do, lse, dsum, causal, window, q_offset, scale,
               block_k):
    """Per kv tile of ``block_k`` keys: ``(k0, qf, kt, p, ds)`` of the
    recompute backward, float32, K and V repeated over each group:
    ``p = exp(s - lse)`` on live entries and exactly 0 on masked ones,
    ``ds = p * (dO V^T - dsum)``."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    dof = do.float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    for k0 in range(0, k.shape[2], block_k):
        kt = kf[:, :, k0:k0 + block_k]
        k_pos = torch.arange(k0, k0 + kt.shape[2], device=q.device)
        mask = _attention_mask(q_pos, k_pos, causal, window)
        s = (qf * scale) @ kt.transpose(-1, -2)
        p = torch.where(mask, torch.exp(s - lse), 0.0)
        dp = dof @ vf[:, :, k0:k0 + block_k].transpose(-1, -2)
        yield k0, qf, kt, p, p * (dp - dsum)


def flash_attention_dq_ref(q, k, v, do, lse, dsum, *, causal: bool = True,
                           window=None, q_offset: int = 0, scale=None,
                           block_k: int = 64):
    """Plain version of the dq kernel: ``dq = sum over kv tiles of ds K
    scale``, float32, returned in q's dtype.  ``lse`` and ``dsum`` (B,
    Hq, Sq, 1) float32; shapes and positions as
    :func:`flash_attention_ref`."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for _, _, kt, _, ds in _bwd_tiles(q, k, v, do, lse, dsum, causal,
                                      window, q_offset, scale, block_k):
        dq += (ds @ kt) * scale
    return dq.to(q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, dsum, *, causal: bool = True,
                            window=None, q_offset: int = 0, scale=None,
                            block_k: int = 64, prob_bf16: bool = False):
    """Plain version of the dk/dv kernel: per q head, ``dk = ds^T Q
    scale`` and ``dv = p^T dO``, each (B, Hq, Skv, D) float32 (the caller
    sums them over each kv group).  ``prob_bf16`` with bf16 operands: dv
    from p rounded to bf16 (to nearest), ds from float32 p, as the
    kernel's variant for the flag computes them."""
    cast = prob_bf16 and q.dtype == torch.bfloat16
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, hq, _, d = q.shape
    shape = (b, hq, k.shape[2], d)
    dkh = torch.zeros(shape, dtype=torch.float32, device=q.device)
    dvh = torch.zeros(shape, dtype=torch.float32, device=q.device)
    dof = do.float()
    for k0, qf, kt, p, ds in _bwd_tiles(q, k, v, do, lse, dsum, causal,
                                        window, q_offset, scale, block_k):
        n = kt.shape[2]
        dkh[:, :, k0:k0 + n] = (ds.transpose(-1, -2) @ qf) * scale
        if cast:
            p = p.bfloat16().float()
        dvh[:, :, k0:k0 + n] = p.transpose(-1, -2) @ dof
    return dkh, dvh


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window=None, q_offset: int = 0, scale=None,
                            block_k: int = 64, prob_bf16: bool = False):
    """``(dq, dk, dv)`` of the flash-attention backward, the recompute
    scheme of the reference's ``_bwd_impl``: ``D = rowsum(dO o)``, then
    :func:`flash_attention_dq_ref` and :func:`flash_attention_dkv_ref`,
    dk and dv summed over each kv group.  Float32 arithmetic; dq in q's
    dtype, dk and dv in k's.  ``o`` and ``lse`` are the forward's.

    One difference from the reference: ``p`` is 0 on masked entries.  The
    reference takes ``exp(-1e30 - lse)``, which is 1 on the masked entries
    of a row with no live key (its lse is -1e30) and gives that row a
    gradient although its output is the constant 0."""
    b, hq, _, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale,
              block_k=block_k)
    dsum = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = flash_attention_dq_ref(q, k, v, do, lse, dsum, **kw)
    dkh, dvh = flash_attention_dkv_ref(q, k, v, do, lse, dsum,
                                       prob_bf16=prob_bf16, **kw)
    dk = dkh.view(b, hkv, hq // hkv, skv, d).sum(2).to(k.dtype)
    dv = dvh.view(b, hkv, hq // hkv, skv, d).sum(2).to(v.dtype)
    return dq, dk, dv


def bf16_split3(x):
    """``(hi, mid, lo)``, bfloat16: the three bf16 terms into which the
    backward kernels split a float32 operand (p or ds) to multiply it on
    the tensor cores.  ``hi`` is x cut to bf16 (its upper 16 bits, i.e.
    rounded toward zero), ``mid`` the same of ``x - hi``, ``lo`` of
    ``x - hi - mid``.  Both differences are exact in float32, so
    ``hi + mid + lo == x`` bit for bit unless lo is subnormal (|x| below
    about 1e-33), and three bf16 products with float32 sums give the
    float32 product."""
    x = x.float().contiguous()

    def cut(t):
        return (t.view(torch.int32) & -65536).view(torch.float32)

    hi = cut(x)
    mid = cut(x - hi)
    lo = cut(x - hi - mid)
    return hi.bfloat16(), mid.bfloat16(), lo.bfloat16()


def split_matmul(a, b, terms, *, split_a: bool):
    """``a @ b`` with its float32 operand (``a`` if ``split_a``, else
    ``b``) as the tensor-core kernels take it: ``terms=3``, the three bf16
    terms of :func:`bf16_split3`, one float32 product each, summed in
    float32 (the float32 product up to its sums' rounding); ``terms=1``,
    one bf16 cast (round to nearest), what a kernel without the split
    computes; None, ``a @ b`` as it is."""
    if terms is None:
        return a @ b
    x = a if split_a else b
    if terms == 3:
        parts = [t.float() for t in bf16_split3(x)]
    elif terms == 1:
        parts = [x.bfloat16().float()]
    else:
        raise ValueError(f"terms must be 3, 1 or None, got {terms}")
    out = None
    for t in parts:
        prod = t @ b if split_a else a @ t
        out = prod if out is None else out + prod
    return out


def ssd_scan_ref(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int,
                 state=None):
    """``(y, final_state)`` of the Mamba-2 SSD chunked scan, in the
    reference kernel's order of operations, chunk by chunk with the
    float32 (N, P) state carried across; the last chunk may be short.

    x: (B, L, H, P); dt: (B, L, H) (positive step sizes); a_log, d_skip:
    (H,); b_mat, c_mat: (B, L, G, N), H % G == 0; state: optional (B, H,
    N, P) initial state.  ``y`` in x's dtype, the state float32.
    """
    bsz, length, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    a = -torch.exp(a_log.float())                            # (H,)
    xf, dtf = x.float(), dt.float()
    bf = b_mat.float().repeat_interleave(rep, dim=2)         # (B, L, H, N)
    cf = c_mat.float().repeat_interleave(rep, dim=2)
    s = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    ys = []
    for c0 in range(0, length, chunk):
        xc = xf[:, c0:c0 + chunk].transpose(1, 2)            # (B, H, Q, P)
        dtc = dtf[:, c0:c0 + chunk].transpose(1, 2)          # (B, H, Q)
        bc = bf[:, c0:c0 + chunk].transpose(1, 2)            # (B, H, Q, N)
        cc = cf[:, c0:c0 + chunk].transpose(1, 2)
        q = xc.shape[2]
        # the cumsum in float64, differences rounded to float32 before
        # the exp (see csrc/ssd_scan.cu)
        cum = torch.cumsum((dtc * a[None, :, None]).double(), dim=-1)
        causal = torch.ones((q, q), dtype=torch.bool,
                            device=x.device).tril()
        # mask before the exp: cum_i - cum_j > 0 above the diagonal
        seg = torch.where(causal,
                          (cum[..., :, None] - cum[..., None, :]).float(),
                          float("-inf"))
        scores = (cc @ bc.transpose(-1, -2)) * torch.exp(seg)
        xdt = xc * dtc[..., None]
        y = scores @ xdt
        y = y + (cc @ s) * torch.exp(cum.float())[..., None]
        y = y + xc * d_skip.float()[None, :, None, None]
        ys.append(y.transpose(1, 2))
        last = cum[..., -1:]
        w = torch.exp((last - cum).float())[..., None]        # (B, H, Q, 1)
        s = torch.exp(last.float())[..., None] * s \
            + bc.transpose(-1, -2) @ (xdt * w)
    return torch.cat(ys, dim=1).to(x.dtype), s


def ssd_scan_chunked_ref(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int,
                         state=None, terms=None):
    """``(y, final_state)`` of :func:`ssd_scan_ref` by the chunk-parallel
    decomposition of the bf16 kernels (``csrc/ssd_scan.cu``), float32:

    1. chunk states: ``L_c = B_c^T (x_c (dt w))``, ``w = exp(cum[-1] -
       cum)``, for every chunk at once;
    2. state passing: ``S_in[c] = S``, ``S = exp(cum_c[-1]) S + L_c``,
       from the initial state (or zero);
    3. chunk output: ``y = (C B^T exp(seg) dt_j) x + (C S_in) exp(cum) +
       x d_skip``, the terms in the reference's order, dt folded into the
       scores.

    ``terms`` (3 or 1) multiplies the float32 operand of each product but
    C B^T (x dt w, the scores, S_in) as that many bf16 terms
    (:func:`split_matmul`); None in float32.  Shapes as
    :func:`ssd_scan_ref`; the last chunk may be short."""
    bsz, length, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    a = -torch.exp(a_log.float())
    xf, dtf = x.float(), dt.float()
    bf = b_mat.float().repeat_interleave(rep, dim=2)
    cf = c_mat.float().repeat_interleave(rep, dim=2)
    chunks = []
    for c0 in range(0, length, chunk):
        dtc = dtf[:, c0:c0 + chunk].transpose(1, 2)          # (B, H, Q)
        chunks.append((xf[:, c0:c0 + chunk].transpose(1, 2), dtc,
                       bf[:, c0:c0 + chunk].transpose(1, 2),
                       cf[:, c0:c0 + chunk].transpose(1, 2),
                       torch.cumsum((dtc * a[None, :, None]).double(), -1)))
    own = []                                                 # 1.
    for xc, dtc, bc, _, cum in chunks:
        f = dtc * torch.exp((cum[..., -1:] - cum).float())
        own.append(split_matmul(bc.transpose(-1, -2), xc * f[..., None],
                                terms, split_a=False))
    s = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    s_in = []                                                # 2.
    for (*_, cum), lc in zip(chunks, own):
        s_in.append(s)
        s = torch.exp(cum[..., -1:].float())[..., None] * s + lc
    ys = []                                                  # 3.
    for (xc, dtc, bc, cc, cum), si in zip(chunks, s_in):
        q = xc.shape[2]
        causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        seg = torch.where(causal,
                          (cum[..., :, None] - cum[..., None, :]).float(),
                          float("-inf"))
        scores = (cc @ bc.transpose(-1, -2)) * torch.exp(seg) \
            * dtc[..., None, :]
        y = split_matmul(scores, xc, terms, split_a=True)
        y = y + split_matmul(cc, si, terms, split_a=False) \
            * torch.exp(cum.float())[..., None]
        y = y + xc * d_skip.float()[None, :, None, None]
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1).to(x.dtype), s


def ssd_scan_bwd_ref(x, dt, a_log, b_mat, c_mat, d_skip, dy, *, chunk: int,
                     state=None, dfinal=None, terms=None):
    """Gradients of :func:`ssd_scan_chunked_ref`'s ``(y, final_state)``
    given ``dy`` (like y) and ``dfinal`` (like the final state, or None
    for zero): ``(dx, ddt, da_log, db, dc, dd_skip, dstate)``, float32 in
    the inputs' shapes, ``dstate`` None without an initial state.

    Written by hand from the three phases of the chunked form, in the
    order of the backward kernels (``csrc/ssd_scan_bwd.cu``).  Per (b, h)
    and chunk, with ``cum`` the in-chunk cumsum of dt a (float64),
    ``L_ij = exp(cum_i - cum_j)`` on and below the diagonal, ``w_j =
    exp(cum[-1] - cum_j)``, ``S_in`` the state entering the chunk and
    ``dS`` the gradient of the state leaving it:

    1. each chunk's own state ``B^T (x dt w)`` and the pull of its output
       on its entering state, ``C^T (exp(cum) dy)``;
    2. state passing, forward to give every ``S_in``, then in reverse
       from ``dfinal``: ``dS_in = exp(cum[-1]) dS + C^T (exp(cum) dy)``;
    3. per chunk, with ``G_ij = dy_i . x_j`` and ``Z = G L dt_j``:
       ``dx = dt ((C B^T L)^T dy + w (B dS)) + D dy``, ``dC = Z B +
       exp(cum) (dy S_in^T)``, ``dB = Z^T C + w dt (x dS^T)``, the direct
       ``ddt = sum_i (C_i.B_j) L_ij G_ij + w x.(B dS)``, and ``dcum``
       (row sums less column sums of ``M = (C B^T) L dt_j G``, the
       ``exp(cum) dy.(C S_in)`` term, the two terms of the leaving state
       on the last row and ``-w dt x.(B dS)``), whose reverse cumsum is
       the gradient of dt a.

    Float32 throughout; the cumsums (forward and reverse) and the terms
    of ``dcum`` in float64: its row and column sums of ``M`` cancel in
    the reverse cumsum, and summed in float32 they put 2e-4 of d a_log's
    size into it at a real layer's decay.

    ``terms`` (3 or 1) multiplies the float32 operand of each product but
    ``C B^T`` and ``dy x^T`` (x dt w, exp(cum) dy, S L, G L dt_j, G L,
    S_in, dS) as that many bf16 terms (:func:`split_matmul`), as the
    tensor-core kernels of ``csrc/ssd_scan_bwd.cu`` do with 3; None in
    float32."""
    def mm(a, b, split_a):
        return split_matmul(a, b, terms, split_a=split_a)

    bsz, length, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    f32 = torch.float32
    a = -torch.exp(a_log.float())
    xf, dtf, dyf = x.float(), dt.float(), dy.float()
    bf = b_mat.float().repeat_interleave(rep, dim=2)
    cf = c_mat.float().repeat_interleave(rep, dim=2)
    dsk = d_skip.float()[None, :, None, None]
    chunks = []
    for c0 in range(0, length, chunk):
        dtc = dtf[:, c0:c0 + chunk].transpose(1, 2)          # (B, H, Q)
        cum = torch.cumsum((dtc * a[None, :, None]).double(), -1)
        chunks.append((xf[:, c0:c0 + chunk].transpose(1, 2), dtc,
                       bf[:, c0:c0 + chunk].transpose(1, 2),
                       cf[:, c0:c0 + chunk].transpose(1, 2),
                       dyf[:, c0:c0 + chunk].transpose(1, 2), cum,
                       torch.exp((cum[..., -1:] - cum).float()),
                       torch.exp(cum.float())))
    own, pull = [], []                                       # 1.
    for xc, dtc, bc, cc, dyc, _, w, ecum in chunks:
        own.append(mm(bc.transpose(-1, -2), xc * (dtc * w)[..., None],
                      False))
        pull.append(mm(cc.transpose(-1, -2), dyc * ecum[..., None], False))
    s = (torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
         if state is None else state.float())
    s_in = []                                                # 2.
    for ch, lc in zip(chunks, own):
        s_in.append(s)
        s = torch.exp(ch[5][..., -1:].float())[..., None] * s + lc
    ds = (torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
          if dfinal is None else dfinal.float())
    ds_out = [None] * len(chunks)
    for c in reversed(range(len(chunks))):
        ds_out[c] = ds
        ds = torch.exp(chunks[c][5][..., -1:].float())[..., None] * ds \
            + pull[c]
    dxs, ddts, dbs, dcs = [], [], [], []                     # 3.
    da = torch.zeros((bsz, h), dtype=torch.float64, device=x.device)
    for (xc, dtc, bc, cc, dyc, cum, w, ecum), si, so in zip(chunks, s_in,
                                                             ds_out):
        q = xc.shape[2]
        causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        seg = torch.where(causal,
                          (cum[..., :, None] - cum[..., None, :]).float(),
                          float("-inf"))
        lmat = torch.exp(seg)
        sl = (cc @ bc.transpose(-1, -2)) * lmat              # C B^T L
        gm = dyc @ xc.transpose(-1, -2)                      # G_ij
        y_ = gm * lmat                                       # G L
        z = y_ * dtc[..., None, :]                           # G L dt_j
        bds = mm(bc, so, False)                              # B dS
        dys = mm(dyc, si.transpose(-1, -2), False)           # dy S_in^T
        xbds = (xc * bds).sum(-1)                            # x.(B dS)
        dxs.append((dtc[..., None] * (mm(sl.transpose(-1, -2), dyc, True)
                                      + w[..., None] * bds)
                    + dsk * dyc).transpose(1, 2))
        dcs.append((mm(z, bc, True) + ecum[..., None] * dys)
                   .transpose(1, 2))
        dbs.append((dtc[..., None] * (mm(y_.transpose(-1, -2), cc, True)
                                      + w[..., None] * mm(
                                          xc, so.transpose(-1, -2), False)))
                   .transpose(1, 2))
        qdir = (sl * gm).sum(-2)                 # sum_i (C_i.B_j) L_ij G_ij
        t = w * dtc * xbds
        m = (sl * gm * dtc[..., None, :]).double()   # M_ij
        dcum = m.sum(-1) - m.sum(-2) - t.double() \
            + (ecum * (cc * dys).sum(-1)).double()
        dcum[..., -1] += (torch.exp(cum[..., -1].float())
                          * (si * so).sum((-1, -2))).double() \
            + t.double().sum(-1)
        dda = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
        ddts.append((qdir + w * xbds + a[None, :, None] * dda.float())
                    .transpose(1, 2))
        da += (dtc.double() * dda).sum(-1)
    dx = torch.cat(dxs, dim=1)
    db = torch.cat(dbs, dim=1).reshape(bsz, length, g, rep, n).sum(3)
    dc = torch.cat(dcs, dim=1).reshape(bsz, length, g, rep, n).sum(3)
    da_log = a * da.sum(0).float()
    dd = (dyf * xf).sum((0, 1, 3))
    return (dx, torch.cat(ddts, dim=1), da_log, db, dc, dd,
            ds if state is not None else None)


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  q_offset: int = 0, kv_len=None, scale=None):
    """Masked multi-head GQA attention in one piece (the oracle).

    Shapes and positions as :func:`flash_attention_ref`; ``kv_len`` (B,)
    masks keys at or beyond it (padded decode caches).  A row with no
    live key gives zeros.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = qf @ kf.transpose(-1, -2)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = _attention_mask(q_pos, k_pos, causal, window).expand(
        b, hq, sq, skv)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=q.device).reshape(b, 1, 1, 1)
        mask = mask & (k_pos < kl)
    logits = torch.where(mask, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return (probs @ vf).to(q.dtype)


def ssd_ref(x, dt, a_log, b_mat, c_mat, d_skip, *, state=None):
    """Mamba-2 SSD as its exact sequential recurrence (the oracle); shapes
    as :func:`ssd_scan_ref`.  Returns ``(y, final_state)``."""
    bsz, length, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    a = -torch.exp(a_log.float())
    xf, dtf = x.float(), dt.float()
    bf = b_mat.float().repeat_interleave(rep, dim=2)
    cf = c_mat.float().repeat_interleave(rep, dim=2)
    s = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    ys = []
    for t in range(length):
        decay = torch.exp(dtf[:, t] * a[None, :])            # (B, H)
        s = s * decay[..., None, None] + bf[:, t, :, :, None] \
            * (xf[:, t] * dtf[:, t, :, None])[:, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, t], s))
    y = torch.stack(ys, dim=1) + xf * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), s


def moe_dense_ref(x2d, w_gate, w_up, w_down, top_w, top_idx, *,
                  acc_dtype=None):
    """The reference's ``_dense_path``: every expert's SiLU-GLU MLP on
    every token, weighted by the token's renormalised top-k weight for
    that expert (0 where it did not pick it) and summed over the experts
    in expert order.  x2d (T, M); w_gate, w_up (E, M, F); w_down (E, F,
    M); top_w, top_idx (T, k).  The expert MLPs run in x2d's dtype; the
    weighting and the running sum run in ``acc_dtype``, by default x2d's
    dtype too (the reference rounds the weights and every partial sum to
    the activation dtype; float32 keeps the weights as the router gives
    them, as the port's route does)."""
    dt = x2d.dtype
    acc = acc_dtype or dt
    out = torch.zeros(x2d.shape, dtype=acc, device=x2d.device)
    for e in range(w_gate.shape[0]):
        w = ((top_idx == e).to(acc) * top_w.to(acc)).sum(-1)
        h = torch.nn.functional.silu(x2d @ w_gate[e].to(dt)) \
            * (x2d @ w_up[e].to(dt))
        out = out + (h @ w_down[e].to(dt)).to(acc) * w[:, None]
    return out.to(dt)
