#!/usr/bin/env python3
"""Time variants of the mask+GEMM kernels (src/repro_torch/kernels/csrc/
mask_gemm.cu) beside the built extension, on one NVIDIA card, at every
level of the first PN(64) source block in float64.

    python3 scripts/mask_gemm_variants.py [--only NAME,...] [--rounds 2]

Each variant is the kernel source with a few lines replaced, compiled by
nvcc (sm_90a) into a shared library under build/mask_gemm_variants/ and
called through a plain C shim.  Exact variants are held bit for bit
against the tiled mirror (ref.frontier_step_tiled_ref /
backward_step_tiled_ref); ablations, which drop a part of the work to
show what it costs, are timed only.  Times are CUDA events over 20
launches, every variant once per round, rounds in turn.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/mask_gemm.cu"
OUT = ROOT / "build/mask_gemm_variants"

# name -> (exact, [(old, new), ...]) replacements in the kernel source;
# "graph_order" runs the kernel as it is on the triple in the graph's own
# arc order instead of core.graph.bank_order
VARIANTS = {
    "base": (True, []),
    "graph_order": (True, []),
    "threads512": (True, [("return rows <= 3 ? 1024 : 512;",
                           "return 512;")]),
    "threads768": (True, [("return rows <= 3 ? 1024 : 512;",
                           "return rows <= 3 ? 768 : 512;")]),
    "unroll3": (True, [("constexpr int kUnroll = 9;",
                        "constexpr int kUnroll = 3;")]),
    # every gather on a distinct bank pair: what bank conflicts cost
    "no_conflicts": (False, [(
        "const unsigned at = xs_addr + uu * sizeof(T);",
        "const unsigned at = xs_addr + min((uu & ~15u) | (threadIdx.x & 15u),"
        " static_cast<unsigned>(kw - 1)) * sizeof(T);")]),
    # rows of A from a hash of j, unit weights: what the triple's loads cost
    "no_csr_loads": (False, [
        ("u[k] = j < ps.end ? static_cast<unsigned>(p.indices[j]) -",
         "u[k] = j < ps.end ? (static_cast<unsigned>(j) * 2654435761u) %"
         " static_cast<unsigned>(p.n) -"),
        ("a[k] = j < ps.end ? p.data[j] : T(0);", "a[k] = T(1);")]),
    # eight lanes a column, four columns a pass (timed only: another order)
    "lanes8": (False, [("constexpr int kLanes = 16;",
                        "constexpr int kLanes = 8;")]),
    # no xor tree over a column's lanes
    "no_reduction": (False, [(
        "part[r] = add_rn(part[r], __shfl_xor_sync(kFull, part[r], off));",
        "part[r] = part[r];")]),
    # no passes at all: staging, the dist scans and the epilogue alone
    "no_passes": (False, [("for (unsigned rest = cols; rest;) {",
                           "for (unsigned rest = 0; rest;) {")]),
}

SHIM = r'''
extern "C" int fr64(const double* x, const int* ip, const int* ix,
                    const double* dt, const int* d, const double* sg,
                    double* o, int* d_out, double* s_out, int* any_new,
                    long long s, int n, int lvl, int rows, int chunk,
                    int splits, void* st) {
  return (int)mask_frontier_f64(x, ip, ix, dt, d, sg, o, d_out, s_out,
                                any_new, s, n, lvl, rows, chunk, splits,
                                (cudaStream_t)st);
}
extern "C" int bw64(const double* x, const int* ip, const int* ix,
                    const double* dt, const int* d, const double* sg,
                    const double* dl, double* o, long long s, int n, int lvl,
                    int rows, int chunk, int splits, void* st) {
  return (int)mask_backward_f64(x, ip, ix, dt, d, sg, dl, o, s, n, lvl,
                                rows, chunk, splits, (cudaStream_t)st);
}
'''


def build(names):
    """Compile every variant at once, one nvcc each; the loaded libraries."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name][1]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text + SHIM)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-O3",
             "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.fr64.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.bw64.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mask_gemm_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.core import pn_graph
    from repro_torch.core.graph import adjacency_csr
    from repro_torch.kernels import mask_gemm as MG
    from repro_torch.kernels.ref import (backward_step_tiled_ref,
                                         frontier_step_tiled_ref)

    names = args.only.split(",")
    print(C.card_line(), flush=True)
    libs = build(names)
    dev = torch.device("cuda")
    g = pn_graph(64)
    fwd, bwd, _ = C.level_states(g, 756, dev)
    banked = adjacency_csr(g, torch.float64, dev)
    graph_order = banked._replace(indices=torch.as_tensor(
        g.indices, dtype=torch.int32, device=dev))
    csr = banked
    rows, chunk, splits = MG._plan_for(fwd[0][0])
    stream = torch.cuda.current_stream().cuda_stream

    def frontier(lib, front, dist, sigma, lvl):
        out = (torch.empty_like(front), torch.empty_like(dist),
               torch.empty_like(sigma),
               torch.zeros((), dtype=torch.int32, device=dev))
        err = lib.fr64(front.data_ptr(), *(c.data_ptr() for c in csr),
                       dist.data_ptr(), sigma.data_ptr(),
                       *(o.data_ptr() for o in out), front.shape[0],
                       front.shape[1], lvl, rows, chunk, splits, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    def backward(lib, coeff, dist, sigma, delta, lvl):
        out = torch.empty_like(delta)
        err = lib.bw64(coeff.data_ptr(), *(c.data_ptr() for c in csr),
                       dist.data_ptr(), sigma.data_ptr(), delta.data_ptr(),
                       out.data_ptr(), coeff.shape[0], coeff.shape[1], lvl,
                       rows, chunk, splits, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    for name in names:                     # the exact variants are exact
        if not VARIANTS[name][0]:
            continue
        csr = graph_order if name == "graph_order" else banked
        for front, dist, sigma, lvl in fwd:
            got = frontier(libs[name], front, dist, sigma, lvl)
            want = frontier_step_tiled_ref(front, csr, dist, sigma, lvl,
                                           chunk=chunk)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} frontier lvl={lvl} differs")
        for coeff, dist, sigma, delta, lvl in bwd:
            got = backward(libs[name], coeff, dist, sigma, delta, lvl)
            want = backward_step_tiled_ref(coeff, csr, dist, sigma, delta,
                                           lvl, chunk=chunk)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} backward lvl={lvl} differs")
    print(f"plan (rows, chunk, col_splits) {(rows, chunk, splits)}; exact "
          f"variants bit for bit the tiled mirror", flush=True)
    for rnd in range(args.rounds):
        for name in ["extension"] + names:
            csr = graph_order if name == "graph_order" else banked
            fr, bk = [], []
            for front, dist, sigma, lvl in fwd:
                fn = ((lambda: MG.frontier_step(front, csr, dist, sigma, lvl))
                      if name == "extension" else
                      (lambda: frontier(libs[name], front, dist, sigma, lvl)))
                fr.append(C.cuda_ms(fn, 20))
            for coeff, dist, sigma, delta, lvl in bwd:
                fn = ((lambda: MG.backward_step(coeff, csr, dist, sigma,
                                                delta, lvl))
                      if name == "extension" else
                      (lambda: backward(libs[name], coeff, dist, sigma,
                                        delta, lvl)))
                bk.append(C.cuda_ms(fn, 20))
            print(f"round {rnd} {name:13s} frontier by level "
                  + " ".join(f"{x:.4f}" for x in fr)
                  + f" (sum {sum(fr):.4f}) ms | backward by level "
                  + " ".join(f"{x:.4f}" for x in bk)
                  + f" (sum {sum(bk):.4f}) ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
