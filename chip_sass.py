#!/usr/bin/env python3
"""The kernels of two trees of this repo compiled side by side: every
``src/repro_torch/kernels/csrc/*.cu`` file whose text differs between
them goes through ``nvcc -cubin`` with the flags the extension's build
uses (``_build.CUDA_FLAGS`` and those ``torch.utils.cpp_extension.load``
adds), in parallel.  For each kernel instantiation of this tree it
prints ptxas's registers, stack frame and spills, and whether its SASS
(``cuobjdump -sass``, addresses dropped) is the other tree's, the same
instruction for instruction.  Kernels whose SASS is equal run the same
code, so their times in PERF.md stand.

    python3 chip_sass.py A_DIR [B_DIR]

B_DIR defaults to the directory of this script; A_DIR is another
checkout, e.g. the parent commit unpacked by ``git archive HEAD | tar -x
-C scratch_chip/parent``.  The cubins go to ``build/chip_sass/``, the
diff of each kernel that differs to ``chiprun_out/chip_sass.txt``.
Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), no card; exits
non-zero where a build fails.
"""

from __future__ import annotations

import difflib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = Path("src") / "repro_torch" / "kernels" / "csrc"
BUILD = HERE / "build" / "chip_sass"
OUT = HERE / "chiprun_out" / "chip_sass.txt"
# what torch.utils.cpp_extension.load passes nvcc besides CUDA_FLAGS
LOAD_FLAGS = ("-std=c++17", "--expt-relaxed-constexpr",
              "-D__CUDA_NO_HALF_OPERATORS__",
              "-D__CUDA_NO_HALF_CONVERSIONS__",
              "-D__CUDA_NO_BFLOAT16_CONVERSIONS__",
              "-D__CUDA_NO_HALF2_OPERATORS__")
ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")


def tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    return str(Path(CUDA_HOME or "/usr/local/cuda") / "bin" / name)


def instance(symbol: str) -> str:
    """``flash_dq_fma_kernel<fLi256>``: a kernel's name, found by its
    length prefix in the mangled symbol (every digit run is tried from
    each of its digits: the anonymous namespace's name before the prefix
    may end in digits), and its template arguments as mangled; the
    symbol itself where it names no ``*_kernel`` template."""
    for i in range(len(symbol)):
        j = i
        while j < len(symbol) and symbol[j].isdigit():
            j += 1
        if j == i:
            continue
        n = int(symbol[i:j])
        name = symbol[j:j + n]
        if name.endswith("_kernel") and symbol[j + n:j + n + 1] == "I":
            args = symbol[j + n + 1:symbol.find("Ev", j + n)]
            return f"{name}<{args.rstrip('E')}>"
    return symbol


def compile_one(src: Path, cubin: Path, flags) -> str:
    """ptxas's report of ``src`` compiled to ``cubin`` with nvcc
    ``flags``; raises on a failed build."""
    cmd = [tool("nvcc"), *flags, "-cubin", "-Xptxas", "-v", "-o",
           str(cubin), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc {src}:\n{done.stderr[-4000:]}")
    return done.stderr


def sass(cubin: Path) -> dict:
    """``{instance: [SASS lines]}`` of a cubin, addresses dropped."""
    out = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                         capture_output=True, text=True, check=True).stdout
    funcs = {}
    for part in out.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        funcs[instance(name.strip())] = [ADDRESS.sub("", line).strip()
                                         for line in body.splitlines()]
    return funcs


def usage(report: str) -> dict:
    """``{instance: 'N registers, S bytes stack, X bytes spilled'}`` from
    ptxas's report."""
    rows, name = {}, None
    for line in report.splitlines():
        if "Function properties for" in line:
            name = instance(line.rsplit(" ", 1)[-1])
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            rows[name] = f"{m.group(1)} bytes stack, {m.group(2)} spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows[name] = f"{m.group(1)} registers, {rows.get(name, '')}"
    return rows


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    a = Path(sys.argv[1]).resolve()
    b = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else HERE
    sys.path.insert(0, str(b / "src"))
    from repro_torch.kernels._build import CUDA_FLAGS
    flags = (*CUDA_FLAGS, *LOAD_FLAGS)
    BUILD.mkdir(parents=True, exist_ok=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    names = sorted(p.name for p in (b / CSRC).glob("*.cu")
                   if not (a / CSRC / p.name).exists()
                   or (a / CSRC / p.name).read_text() != p.read_text())
    print(f"sources that differ: {names}", flush=True)
    jobs = [(tree / CSRC / n, BUILD / f"{side}_{n}.cubin")
            for n in names for side, tree in (("a", a), ("b", b))
            if (tree / CSRC / n).exists()]
    with ThreadPoolExecutor(len(jobs) or 1) as ex:
        reports = dict(zip(jobs, ex.map(
            lambda j: compile_one(*j, flags), jobs)))
    diffs = []
    for n in names:
        new_cubin = BUILD / f"b_{n}.cubin"
        old_cubin = BUILD / f"a_{n}.cubin"
        rows = usage(reports[(b / CSRC / n, new_cubin)])
        new = sass(new_cubin)
        old = sass(old_cubin) if old_cubin.exists() else {}
        for name in sorted(new):
            if name not in old:
                verdict = "new"
            elif old[name] == new[name]:
                verdict = "the other tree's SASS"
            else:
                d = list(difflib.unified_diff(old[name], new[name],
                                              lineterm="", n=1))
                verdict = (f"differs ({len(new[name])} lines against "
                           f"{len(old[name])}, {len(d)} diff lines)")
                diffs.append(f"==== {n} {name}\n" + "\n".join(d))
            print(f"{n} {name}: {rows.get(name, '?')}; {verdict}",
                  flush=True)
    OUT.write_text("\n".join(diffs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
