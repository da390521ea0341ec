#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the flow-level simulator on one NVIDIA
card, end to end, and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of the CUDA kernels from ``src/repro_torch/
   kernels/csrc`` into ``build/torch_ext/``.
2. Each kernel against its plain PyTorch version on the card, on the
   real PN(27) route tables: ``fused_step_update`` at the VC1 width
   (1514) and the compacted VC0 width (757) with dead tiles, float64 at
   rtol 1e-12 and float32 at rtol 1e-5 of the max; ``fused_decision`` in
   float64 with thr 0 and 16, identical wherever the comparison is clear
   of rounding (|lhs - rhs| > 1e-9 of the scale).  Then each kernel's
   time, its plain version's time and its HBM bound at the main path's
   shapes.
3. PN(16) uniform under ugal_threshold(0): 24 steps on the fused float32
   step and on the dense float64 step, both on the card, delivered
   histories within 1e-5; then a saturation sweep whose knee must land
   within 0.025 of the analytic theta.
4. The main path at full width: PN(27) (1514 routers), every source to
   the 757 points, ugal_threshold(0), ``backend="auto"`` (must resolve to
   the fused step on 757 compacted columns).  Kernel launch counts are
   zeroed just before the sweep and read just after; the knee must land
   within 0.025 of the analytic theta with every probe's residual
   <= 1e-4.  One probe runs twice and must repeat bitwise.
5. Where a PN(27) step's device time goes: torch.profiler over a short
   run, device time per step by kernel and the device's idle share.

The analytic thetas below are the reference's analytic ``ugal`` theta of
each demand (``repro.core.traffic.saturation_report``), computed on the
CPU: the port's analytic engines come in a later slice.

Output: the card's name and power limit, then a ``kernels`` JSON line,
then ``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero
with no result where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
THETA_PN16_UGAL = 6.971407072988353
THETA_PN27_POINTS_UGAL = 9.454058876003565
KNEE_BUDGET = 0.025
KERNEL_SRC = "src/repro_torch/kernels/csrc/sim_step.cu"


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def hbm_bytes_per_s(name: str) -> float:
    """Published HBM bandwidth of the card model (NVIDIA data sheets)."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    if "H200" in name:
        return 4.8e12
    if "H100" in name:
        return 3.35e12
    raise RuntimeError(f"no published HBM bandwidth for {name!r}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def points_demand(g, q: int) -> np.ndarray:
    """All sources -> every point of PG(2, q), busiest source = 1."""
    from repro_torch.core import normalize_demand
    npts = q * q + q + 1
    dem = np.zeros((g.n, g.n))
    dem[:, :npts] = 1.0
    np.fill_diagonal(dem, 0.0)
    return normalize_demand(dem)


def check_kernels(dev, bw):
    """Phase 2: kernels against plain versions on the PN(27) tables, and
    their times at the main path's shapes."""
    from repro_torch.core import pn_graph
    from repro_torch.kernels import sim_step as K
    from repro_torch.kernels.ref import (fused_decision_ref,
                                         fused_step_update_ref)
    from repro_torch.sim.tables import build_tables

    g = pn_graph(27)
    t = build_tables(g, np.arange(g.n), dtype=torch.float64, device=dev)
    n, k, m = t.n, t.k, t.m
    cols = torch.arange(757, device=dev)            # the 757 points
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"fused_step_update": 0.0, "fused_decision": 0.0}

    def rand(*shape, dtype=torch.float64):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    for width, split_w, deliver_w in (
            (m, t.split, t.deliver),
            (757, t.split[:, :, cols].contiguous(),
             t.deliver[:, :, cols].contiguous())):
        nt = K.n_tiles(width)
        mask = (rand(nt) < 0.7).to(torch.int32)
        mask[0], mask[-1] = 1, 0                    # live and dead tiles
        for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            args = (rand(n, k, width, dtype=dtype), split_w.to(dtype),
                    deliver_w.to(dtype), rand(n, k, dtype=dtype),
                    rand(n, k, dtype=dtype), rand(n, width, dtype=dtype),
                    mask)
            q_out, o_out = K.fused_step_update(*args)
            ref_q, ref_o = fused_step_update_ref(*args)
            torch.cuda.synchronize()
            for got, want in ((q_out, ref_q), (o_out, ref_o)):
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                if not err <= rtol * scale:
                    raise AssertionError(
                        f"fused_step_update W={width} {dtype}: max error "
                        f"{err} > {rtol} * {scale}")
                if dtype == torch.float32:
                    errs["fused_step_update"] = max(
                        errs["fused_step_update"], err)
            log(f"fused_step_update W={width} {dtype}: ok")
        # the decision at the compacted vc0 width, float64
        if width == 757:
            b0 = rand(n, k) * (rand(n, k) < 0.5)
            dist = t.dist_act[:, cols].contiguous()
            hval = t.hval_rem[:, cols].contiguous()
            cand = rand(n, width)
            q_val = rand(n) * 0.05
            for thr in (0.0, 16.0):
                dargs = (b0 * (1.0 + 40.0 * (thr > 0)), split_w, dist, hval,
                         cand, q_val, mask)
                got = K.fused_decision(*dargs, thr)
                want = fused_decision_ref(*dargs, thr)
                q_min = (dargs[0][:, :, None] * split_w).sum(1)
                lhs = dist * q_min
                rhs = thr + hval * q_val[:, None]
                scale = float(torch.maximum(lhs.abs().max(),
                                            rhs.abs().max()))
                clear = (lhs - rhs).abs() > 1e-9 * scale
                bad = int(((got != want) & clear).sum())
                live = float((want != 0).double().mean())
                if bad or not 0.0 < live < 1.0:
                    raise AssertionError(
                        f"fused_decision thr={thr}: {bad} clear cells "
                        f"differ (diverting share {live})")
                errs["fused_decision"] = max(
                    errs["fused_decision"],
                    float(((got - want).abs() * clear).max()))
                log(f"fused_decision thr={thr} float64: ok "
                    f"(diverting share {live:.3f})")

    # times at the main path's shapes (float32; every tile live, as the
    # vc1 plane at PN(27) is once phase-1 fluid reaches every mid)
    f4 = 4
    timing = {}
    args = (rand(n, k, m, dtype=torch.float32),
            t.split.to(torch.float32), t.deliver.to(torch.float32),
            rand(n, k, dtype=torch.float32), rand(n, k, dtype=torch.float32),
            rand(n, m, dtype=torch.float32),
            torch.ones(K.n_tiles(m), dtype=torch.int32, device=dev))
    nt = K.n_tiles(m)
    nbytes = f4 * (4 * n * k * m + 2 * n * k + n * m + n * k) + 4 * nt
    timing["fused_step_update"] = dict(
        ms=cuda_ms(lambda: K.fused_step_update(*args), 20),
        plain_ms=cuda_ms(lambda: fused_step_update_ref(*args), 5),
        bound_ms=nbytes / bw * 1e3, nbytes=nbytes,
        shape=f"N={n} K={k} W={m} float32")
    del args
    c = 757
    split_c = t.split[:, :, cols].to(torch.float32).contiguous()
    dargs = ((rand(n, k, dtype=torch.float32) * 2.0), split_c,
             t.dist_act[:, cols].to(torch.float32).contiguous(),
             t.hval_rem[:, cols].to(torch.float32).contiguous(),
             rand(n, c, dtype=torch.float32),
             rand(n, dtype=torch.float32),
             torch.ones(K.n_tiles(c), dtype=torch.int32, device=dev))
    nbytes = f4 * (n * k + n * k * c + 3 * n * c + n + n * c) \
        + 4 * K.n_tiles(c)
    timing["fused_decision"] = dict(
        ms=cuda_ms(lambda: K.fused_decision(*dargs, 0.0), 20),
        plain_ms=cuda_ms(lambda: fused_decision_ref(*dargs, 0.0), 5),
        bound_ms=nbytes / bw * 1e3, nbytes=nbytes,
        shape=f"N={n} K={k} C={c} float32")
    for name, row in timing.items():
        log(f"{name} [{row['shape']}]: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['nbytes'] / 1e9:.3f} GB)")
    del t, dargs, split_c
    torch.cuda.empty_cache()
    return errs, timing


def check_pn16(dev):
    """Phase 3: fused float32 vs dense float64 on the card, then a knee."""
    from repro_torch.core import make_pattern, normalize_demand, pn_graph
    from repro_torch.sim import SimConfig, Simulator, saturation_sweep

    g = pn_graph(16)
    dem = normalize_demand(make_pattern("uniform").demand(g, None))
    hist = {}
    for backend in ("fused", "dense"):
        sim = Simulator(g, SimConfig(routing="ugal_threshold(0)",
                                     backend=backend), demand=dem,
                        device=dev)
        r = sim.run(dem, 0.5, 24)
        hist[backend] = r.history["delivered"]
        log(f"pn16 {backend} {sim.dtype}: 24 steps, residual "
            f"{r.residual:.3e}")
    ref = hist["dense"]
    gap = float(np.abs(hist["fused"] - ref).max() / np.abs(ref).max())
    log(f"pn16 fused-vs-dense delivered gap {gap:.3e}")
    if not gap <= 1e-5:
        raise AssertionError(f"pn16 fused/dense gap {gap} > 1e-5")
    th = THETA_PN16_UGAL
    t0 = time.perf_counter()
    sw = saturation_sweep(g, "uniform", routing="ugal_threshold(0)",
                          loads=np.array([0.97, 1.08]) * th, steps=40,
                          refine=2, config=SimConfig(backend="fused"),
                          theta_analytic=th, device=dev)
    rel = abs(sw.theta - th) / th
    log(f"pn16 sweep: theta {sw.theta:.4f} vs analytic {th:.4f} "
        f"({sw.theta / th:.4f}x, err {rel:.4f}) in "
        f"{time.perf_counter() - t0:.1f} s, {len(sw.runs)} probes")
    if not rel <= KNEE_BUDGET:
        raise AssertionError(f"pn16 knee error {rel} > {KNEE_BUDGET}")
    return sw


def check_pn27(dev):
    """Phase 4: the main path at full width."""
    from repro_torch.core import pn_graph
    from repro_torch.kernels import sim_step as K
    from repro_torch.sim import SimConfig, Simulator, saturation_sweep

    g = pn_graph(27)
    dem = points_demand(g, 27)
    th = THETA_PN27_POINTS_UGAL
    cfg = SimConfig(routing="ugal_threshold(0)")           # backend=auto
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    sw = saturation_sweep(g, dem, routing="ugal_threshold(0)", config=cfg,
                          loads=np.array([0.95, 1.08]) * th, steps=30,
                          refine=2, theta_analytic=th, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for r in sw.runs:
        log(f"pn27 probe offered {r.offered:.4f}: theta {r.theta:.4f} "
            f"residual {r.residual:.2e} backend {r.backend}")
        if r.backend != "fused":
            raise AssertionError(f"pn27 ran on {r.backend}, not fused")
        if not r.residual <= 1e-4:
            raise AssertionError(f"pn27 residual {r.residual} > 1e-4")
    n_bisect = len(sw.runs) - 2
    rel = abs(sw.theta - th) / th
    log(f"pn27 sweep: theta {sw.theta:.4f} vs analytic {th:.4f} "
        f"({sw.theta / th:.4f}x, err {rel:.4f}); bracket "
        f"[{sw.theta:.4f}, {sw.theta_unstable:.4f}] after {n_bisect} "
        f"bisection steps; {seconds:.1f} s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    if not rel <= KNEE_BUDGET:
        raise AssertionError(f"pn27 knee error {rel} > {KNEE_BUDGET}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 f"path")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = Simulator(g, cfg, demand=dem, device=dev)
    torch.cuda.synchronize()
    log(f"pn27 Simulator set-up (tables, arc index, step): "
        f"{time.perf_counter() - t0:.2f} s")
    if sim.backend != "fused" or sim.dest_cols is None \
            or len(sim.dest_cols) != 757:
        raise AssertionError(f"pn27 auto resolved to {sim.backend} with "
                             f"{None if sim.dest_cols is None else len(sim.dest_cols)} "
                             f"columns, not fused on 757")
    steps = 30
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    a = sim.run(dem, th, steps)
    end.record()
    torch.cuda.synchronize()
    ms_step = start.elapsed_time(end) / steps
    b = sim.run(dem, th, steps)
    for key, va in a.history.items():
        if not np.array_equal(va, b.history[key]):
            raise AssertionError(f"pn27 history[{key!r}] not bitwise "
                                 f"reproducible")
    log(f"pn27 step: {ms_step:.3f} ms/step (CUDA events, {steps} steps, "
        f"history read included); repeat run bitwise equal")
    profile_steps(sim, dem, th)
    return launches


def profile_steps(sim, dem, offered, steps: int = 6):
    """Where a PN(27) step's device time goes: torch.profiler over one
    short run, device time per step by kernel, and the device's idle
    share of the run's wall time (CUDA events)."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        sim.run(dem, offered, steps)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        log("profile: the profiler saw no device time (CUDA events only)")
        return
    log(f"profile: {steps} steps, wall {wall_ms / steps:.3f} ms/step, "
        f"device busy {busy_ms / steps:.3f} ms/step, idle share "
        f"{1.0 - busy_ms / wall_ms:.3f}")
    for ms, count, key in rows[:14]:
        log(f"profile:   {ms / steps:8.4f} ms/step {count / steps:6.1f} "
            f"launches/step  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import extension

    card = card_line()
    name = torch.cuda.get_device_name(0)
    bw = hbm_bytes_per_s(name)
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul must stay off")
    t0 = time.perf_counter()
    extension()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")

    errs, timing = check_kernels(dev, bw)
    check_pn16(dev)
    launches = check_pn27(dev)

    replaces = {"fused_step_update": "src/repro/kernels/sim_step.py:53",
                "fused_decision": "src/repro/kernels/sim_step.py:129"}
    kernels = [{"name": kname, "route": "cuda", "source": KERNEL_SRC,
                "replaces": replaces[kname], "launches": launches[kname],
                "max_abs_err": errs[kname],
                "ms": timing[kname]["ms"],
                "plain_ms": timing[kname]["plain_ms"],
                "bound_ms": timing[kname]["bound_ms"],
                "bound_by": "bytes", "library_ms": None}
               for kname in ("fused_step_update", "fused_decision")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
