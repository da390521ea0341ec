"""repro_torch stands alone: importing every module of the port loads
neither jax nor the reference package, and the entry points refuse to
drop to the CPU quietly."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
import torch.distributed as dist
print(json.dumps({"modules": names, "foreign": loaded,
                  "group": dist.is_initialized()}))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["foreign"] == []
    expected = {"repro_torch.convert", "repro_torch.core.graph",
                "repro_torch.core.traffic", "repro_torch.sim.kernel",
                "repro_torch.kernels.sim_step", "repro_torch.kernels._build",
                "repro_torch.core.utilization", "repro_torch.core.routing",
                "repro_torch.kernels.mask_gemm",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.ssd_scan", "repro_torch.kernels.ops",
                "repro_torch.configs", "repro_torch.configs.base",
                "repro_torch.configs.smollm_135m",
                "repro_torch.configs.mamba2_130m",
                "repro_torch.models.layers", "repro_torch.models.ssm",
                "repro_torch.models.transformer", "repro_torch.models.model",
                "repro_torch.serve.engine", "repro_torch.launch.serve",
                "repro_torch.optim.adamw", "repro_torch.optim.compress",
                "repro_torch.data.pipeline", "repro_torch.train.train_step",
                "repro_torch.train.checkpoint", "repro_torch.train.trainer",
                "repro_torch.launch.train", "repro_torch.core.faults",
                "repro_torch.core.mms", "repro_torch.core.moore",
                "repro_torch.core.reference", "repro_torch.core.registry",
                "repro_torch.core.projective", "repro_torch.fabric",
                "repro_torch.fabric.model", "repro_torch.sim.faults",
                "repro_torch.core.orbits", "repro_torch.core.cost",
                "repro_torch.core.layout", "repro_torch.core.select",
                "repro_torch.core.adversary", "repro_torch.paper_tables",
                "repro_torch.fabric.collectives",
                "repro_torch.fabric.placement",
                "repro_torch.fabric.planner",
                "repro_torch.placement_tables", "repro_torch.obs",
                "repro_torch.obs.metrics", "repro_torch.obs.trace",
                "repro_torch.obs.recorder", "repro_torch.obs.watchdog",
                "repro_torch.obs.export", "repro_torch.obs.report",
                "repro_torch.perf", "repro_torch.models.common",
                "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
                "repro_torch.train.elastic"}
    assert expected <= set(res["modules"])
    # importing the mesh functions and the dry run opens no process group
    assert res["group"] is False


def test_port_sources_never_name_the_reference():
    """No module of the port or the chip script imports jax or repro."""
    root = SRC.parent
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "repro"), \
                    f"{path.name}: {line.strip()}"
    assert len(files) > 15


def test_simulator_without_device_needs_cuda():
    from repro_torch.core import pn_graph
    from repro_torch.sim import SimConfig, Simulator
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(pn_graph(2), SimConfig())
    sim = Simulator(pn_graph(2), SimConfig(), device="cpu")
    assert sim.tables.split.device.type == "cpu"


def test_analytic_entry_points_without_device_need_cuda():
    from repro_torch.core import pn_graph, saturation_report, utilization
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    g = pn_graph(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        utilization(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        saturation_report(g, "uniform", routing="ugal")
    assert utilization(g, device="cpu").u == pytest.approx(1.0, abs=1e-12)


def test_fault_entry_points_without_device_need_cuda():
    """The fault model's entry points default to the card and raise
    where there is none; device='cpu' is the way onto the CPU."""
    from repro_torch.core import (FaultSet, degradation_sweep,
                                  degraded_report, distance_distribution,
                                  pn_graph, random_faults, targeted_faults)
    from repro_torch.sim import SimConfig, Simulator
    from repro_torch.sim.tables import build_tables
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    g = pn_graph(2)
    fs = random_faults(g, k_links=1, seed=0)
    for call in (lambda: degraded_report(g, "uniform", fs),
                 lambda: degradation_sweep(g, k_failures=(0, 1), trials=1),
                 lambda: targeted_faults(g, k=1),
                 lambda: distance_distribution(g),
                 lambda: build_tables(g, range(g.n), faults=fs)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    sim = Simulator(g, SimConfig(), device="cpu")
    run = sim.run(_uniform(g), 0.1, 8, events=[(4, fs)])
    assert run.faults == fs.label and run.device == "cpu"
    assert sim._tables_for(fs)[0].split.device.type == "cpu"
    assert degraded_report(g, "uniform", FaultSet(routers=[0]),
                           device="cpu").faults == "routers[0]"


def test_fabric_entry_points_without_device_need_cuda():
    """The fabric layer's entry points default to the card and raise
    where there is none; device='cpu' is the way onto the CPU."""
    from repro_torch.core import pn_graph
    from repro_torch.fabric import (FabricModel, StepProfile,
                                    evaluate_placements,
                                    fragmentation_sweep, link_loads,
                                    make_fabric, place_mesh,
                                    placement_report, placement_search,
                                    plan)
    from repro_torch.placement_tables import placement_one
    from repro_torch.sim import simulate_placement
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    g = pn_graph(2)
    prof = StepProfile({"all-to-all": 1.0, "all-reduce": 1.0})
    p = place_mesh(g, (2, 2), ("data", "model"), 1, device="cpu")
    for call in (lambda: FabricModel(g),
                 lambda: make_fabric("pn", args=(2,)),
                 lambda: place_mesh(g, (2, 2), ("data", "model"), 1),
                 lambda: placement_report(p, prof),
                 lambda: link_loads(p, ([0], [1], [1.0])),
                 lambda: evaluate_placements(g, (2, 2), ("data", "model"),
                                             1, prof),
                 lambda: placement_search(g, (2, 2), ("data", "model"), 1,
                                          prof),
                 lambda: fragmentation_sweep(
                     g, [((2, 2), ("data", "model"), prof)], 1),
                 lambda: plan(prof, min_terminals=10),
                 lambda: simulate_placement(p, prof),
                 lambda: placement_one(g, (2, 2), ("model", "data"), 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    fab = FabricModel(g, device="cpu")
    assert fab.device.type == "cpu"
    assert fab.placement_report(prof, p).theta > 0
    assert simulate_placement(p, prof, steps=8, device="cpu").device == "cpu"

def _uniform(g):
    from repro_torch.core import make_pattern, normalize_demand
    return normalize_demand(make_pattern("uniform").demand(g, None))


def test_mask_gemm_kernels_are_in_the_one_build():
    """Every kernel source goes to the single extension build, and only
    the binding file includes PyTorch's headers (the kernels' shared
    header wgmma.cuh none)."""
    from repro_torch.kernels import _build
    names = [p.name for p in _build.SOURCES]
    assert names == ["sim_step.cu", "mask_gemm.cu", "flash_attention.cu",
                     "flash_attention_fma.cu", "flash_attention_bwd.cu",
                     "flash_attention_bwd_fma.cu", "ssd_scan.cu",
                     "ssd_scan_fma.cu", "ssd_scan_bwd.cu",
                     "ssd_scan_bwd_fma.cu", "sim_step_binding.cpp"]
    header = _build.SOURCES[0].parent / "wgmma.cuh"
    for path in (*_build.SOURCES, header):
        text = path.read_text()
        assert ("#include <torch/" in text or "#include <ATen/" in text) \
            == (path.suffix == ".cpp"), path.name


def test_serving_entry_points_without_device_need_cuda():
    """Engine, the bundle's init and the serve launcher default to the
    card and raise where there is none; device='cpu' is the way onto the
    CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import build
    from repro_torch.serve import Engine
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = get_arch("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg).init(0)
    model = build(cfg).init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve("smollm-135m", requests=1, max_new=1)
    assert Engine(cfg, model, device="cpu").device.type == "cpu"
