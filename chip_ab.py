#!/usr/bin/env python3
"""Two trees of this repo timed side by side on one card: for each,
smollm-135m served at full width (``chip_smoke.serve_arch``, phase 11),
the device time of a 1536-token prefill and of a batch-4 decode step
(``chip_smoke.profile_serve``, phase 13, twice) and smollm-135m trained
at full width with one step profiled (``chip_smoke.train_smollm``, phase
15).  The trees run in the order A, B, B, A, each in a process of its
own that builds that tree's kernels, so that both meet the same card and
host.

    python3 chip_ab.py A_DIR [B_DIR]

B_DIR defaults to the directory of this script.  A_DIR is another
checkout, e.g. the parent commit unpacked by ``git archive HEAD~1 | tar
-x -C scratch_chip/parent``.  Each run's whole log goes to
``chiprun_out/ab/``; the summary lines are printed.  Needs one NVIDIA
card; exits non-zero where a run fails or there is no card.
"""

from __future__ import annotations

import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE / "chiprun_out" / "ab"
SUMMARY = re.compile(r"^=== |serve, warm run|device busy")


def one(tree: Path) -> None:
    """The timed steps for ``tree``, in this process."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels._build import extension

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device")
    cs.log(f"=== {tree}: {cs.card_line()}")
    t0 = time.perf_counter()
    extension()
    cs.log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    model, _, _ = cs.serve_arch(dev, "smollm-135m", "flash_attention_fwd")
    for _ in range(2):
        cs.profile_serve(dev, model, "smollm-135m")
    del model
    torch.cuda.empty_cache()
    cs.train_smollm(dev)
    cs.log(f"=== {tree}: done")


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        one(Path(argv[1]).resolve())
        return 0
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [Path(a).resolve() for a in argv] + [HERE][:2 - len(argv)]
    OUT.mkdir(parents=True, exist_ok=True)
    for i, (label, tree) in enumerate(zip("ABBA", trees + trees[::-1])):
        path = OUT / f"{i}_{label}.log"
        with open(path, "w") as f:
            rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                 "--one", str(tree)], stdout=f,
                                stderr=subprocess.STDOUT).returncode
        lines = path.read_text().splitlines()
        print(f"--- run {i}: {label} = {tree} (exit {rc})")
        for line in (lines[-40:] if rc else lines):
            if rc or SUMMARY.search(line):
                print(line[:400])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
