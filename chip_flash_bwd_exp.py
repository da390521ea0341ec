#!/usr/bin/env python3
"""Kernels #6 and #7 (bf16 operands, tensor cores) built twice and held
side by side at smollm-135m's training shape (B=8, Hq=9, Hkv=3, S=2048,
D=64, bf16, causal):

* ``ex2``: p = 2^(s scale log2 e - lse log2 e) on the special-function
  unit's ``ex2.approx``, the build the port uses;
* ``expf``: p = expf(s scale - lse), the exp of the CUDA-core kernels
  (``flash_attention_bwd.cu`` compiled with ``-DFLASH_BWD_EXPF``).

For each build: dq, dk and dv per q head against the plain float32
version (``repro_torch.kernels.ref``) and against a float64 recompute
from the same inputs, so that the error of either exp shows apart from
that of the tensor cores' float32 sums; and each kernel's time by CUDA
events and by device time (torch.profiler), in the order ex2, expf,
expf, ex2.

    python3 chip_flash_bwd_exp.py

Needs one NVIDIA card and ``nvcc``; builds into ``build/torch_ext/`` and
``build/torch_ext/expf/``.  Exits non-zero where there is no card.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as CS


def plain64(q, k, v, do, lse, dsum, scale, block_k: int = 64):
    """``(dq, dk, dv)`` of the causal recompute backward in float64,
    dk and dv per q head: the plain version's arithmetic, each product
    exact to float64."""
    from repro_torch.kernels.ref import _attention_mask
    group = q.shape[1] // k.shape[1]
    qf, dof = q.double(), do.double()
    kf = k.double().repeat_interleave(group, dim=1)
    vf = v.double().repeat_interleave(group, dim=1)
    lse, dsum = lse.double(), dsum.double()
    dq = torch.zeros_like(qf)
    dk = torch.zeros((*q.shape[:2], k.shape[2], q.shape[3]),
                     dtype=torch.float64, device=q.device)
    dv = torch.zeros_like(dk)
    q_pos = torch.arange(q.shape[2], device=q.device)
    for k0 in range(0, k.shape[2], block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        n = kt.shape[2]
        mask = _attention_mask(q_pos, torch.arange(k0, k0 + n,
                                                   device=q.device),
                               True, None)
        p = torch.where(mask, torch.exp((qf * scale) @ kt.transpose(-1, -2)
                                        - lse), 0.0)
        ds = p * (dof @ vt.transpose(-1, -2) - dsum)
        dq += (ds @ kt) * scale
        dk[:, :, k0:k0 + n] = (ds.transpose(-1, -2) @ qf) * scale
        dv[:, :, k0:k0 + n] = p.transpose(-1, -2) @ dof
    return dq, dk, dv


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_flash_bwd_exp: no CUDA device; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(CS.ROOT / "src"))
    from torch.utils.cpp_extension import load
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as FA

    CS.log(f"card: {CS.card_line()}")
    variant_dir = _build.BUILD_DIR / "expf"
    variant_dir.mkdir(parents=True, exist_ok=True)
    builds = {
        "ex2": _build.extension(),
        "expf": load(name="repro_torch_kernels_expf",
                     sources=[str(s) for s in _build.SOURCES],
                     build_directory=str(variant_dir),
                     extra_cflags=["-O2"],
                     extra_cuda_cflags=[*_build.CUDA_FLAGS,
                                        "-DFLASH_BWD_EXPF"],
                     verbose=False)}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    b, hq, hkv, s, d = 8, 9, 3, 2048, 64
    scale = d ** -0.5
    q, do = (torch.randn((b, hq, s, d), generator=gen,
                         device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    o, lse = FA.flash_attention(q, k, v)
    dsum = (do.float() * o.float()).sum(-1, keepdim=True)
    dq_out = torch.empty_like(q)
    dk_out = torch.empty((b, hq, s, d), dtype=torch.float32, device=dev)
    dv_out = torch.empty_like(dk_out)

    def dq_call(ext):
        return lambda: ext.flash_dq(q, k, v, do, lse, dsum, True, 0, 0,
                                    scale, dq_out)

    def dkv_call(ext):
        return lambda: ext.flash_dkv(q, k, v, do, lse, dsum, True, 0, 0,
                                     scale, False, dk_out, dv_out)

    w32 = (ref.flash_attention_dq_ref(*(t.float() for t in (q, k, v, do)),
                                      lse, dsum),
           *ref.flash_attention_dkv_ref(q, k, v, do, lse, dsum))
    w64 = plain64(q, k, v, do, lse, dsum, scale)

    def worst(got, want):
        """Max abs error, and the max of |error| / (2e-4 + 2e-5 |want|),
        phase 14's limit for dk and dv."""
        diff = (got.double() - want.double()).abs()
        return (float(diff.max()),
                float((diff / (2e-4 + 2e-5 * want.double().abs())).max()))

    for what, got, want in zip(("dk", "dv"), w32[1:], w64[1:]):
        e, r = worst(got, want)
        CS.log(f"plain float32 {what} against float64: max abs err "
               f"{e:.3e} ({r:.3f} of phase 14's limit)")
    CS.log(f"plain float32 dq rounded to bf16: "
           f"{CS._same_share(w32[0].bfloat16(), w64[0]):.5f} of the "
           f"entries equal the float64 dq rounded to bf16")
    for name, ext in builds.items():
        dq_call(ext)()
        dkv_call(ext)()
        torch.cuda.synchronize()
        e_dq, _ = worst(dq_out, w32[0].bfloat16())
        CS.log(f"{name}: dq max abs err {e_dq:.3e} against the plain dq in "
               f"bf16; {CS._same_share(dq_out, w32[0]):.5f} of dq equal to "
               f"the plain float32 dq rounded, "
               f"{CS._same_share(dq_out, w64[0]):.5f} to the float64 dq "
               f"rounded")
        for what, got, i in (("dk", dk_out, 1), ("dv", dv_out, 2)):
            e32, r32 = worst(got, w32[i])
            e64, r64 = worst(got, w64[i])
            CS.log(f"{name}: {what} max abs err {e32:.3e} against the plain "
                   f"float32 ({r32:.3f} of phase 14's limit), {e64:.3e} "
                   f"against float64 ({r64:.3f})")

    for kname, call in (("flash_attention_dq", dq_call),
                        ("flash_attention_dkv", dkv_call)):
        for name in ("ex2", "expf", "expf", "ex2"):
            fn = call(builds[name])
            ev_ms = CS.cuda_ms(fn, 20)
            _, _, busy_ms, lead_us = CS.device_rows(fn, 20)
            dev_ms = busy_ms / 20
            CS.log(f"{kname} {name}: {ev_ms:.4f} ms by CUDA events, "
                   f"{dev_ms:.4f} ms of device time (every launch recorded, "
                   f"kernels start {lead_us:.1f} us or more after their "
                   f"launch calls)")
    CS.log(f"card: {CS.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
