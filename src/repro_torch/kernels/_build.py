"""Build the port's CUDA kernels at first use.

All sources go to one ``torch.utils.cpp_extension.load`` call: the
kernels (``csrc/*.cu``, plain CUDA C++ with no PyTorch header; the
tensor-core ones share ``csrc/wgmma.cuh``) and the one small binding
file, the only one that includes PyTorch headers.  The kernels are
compiled with ``nvcc`` for ``sm_90a`` (Hopper) into ``build/torch_ext/``
at the repository root, which ``.gitignore`` lists; ninja compiles the
sources in parallel.
The first build in a fresh checkout took 62.0 s for the ten kernel
sources and the binding (Python 3.12, torch 2.11, CUDA 12.8, on the
host of an H100), paced by ``ssd_scan_bwd.cu`` and its 27
instantiations; later builds in the same checkout reuse the cache.
The extension links against nothing beyond PyTorch and the CUDA
runtime: the tensor-core kernels copy with ``cp.async``, not TMA, so
they need no tensor-map descriptors from ``libcuda`` (``-lcuda``).

Nothing here runs at import time: a machine without ``nvcc`` imports the
package and runs the kernels' plain versions on CPU tensors.  A failed
build raises.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

__all__ = ["extension", "SOURCES", "BUILD_DIR"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "sim_step.cu", _CSRC / "mask_gemm.cu",
           _CSRC / "flash_attention.cu", _CSRC / "flash_attention_fma.cu",
           _CSRC / "flash_attention_bwd.cu",
           _CSRC / "flash_attention_bwd_fma.cu", _CSRC / "ssd_scan.cu",
           _CSRC / "ssd_scan_fma.cu", _CSRC / "ssd_scan_bwd.cu",
           _CSRC / "ssd_scan_bwd_fma.cu", _CSRC / "sim_step_binding.cpp")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")


@functools.cache
def extension():
    """The compiled extension module (built once per process)."""
    from torch.utils.cpp_extension import load
    os.makedirs(BUILD_DIR, exist_ok=True)  # load() needs it to exist
    return load(name="repro_torch_kernels",
                sources=[str(s) for s in SOURCES],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O2"],
                extra_cuda_cflags=list(CUDA_FLAGS),
                verbose=False)
