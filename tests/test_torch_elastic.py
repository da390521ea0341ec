"""repro_torch.train.elastic against repro.train.elastic: the survivor
mesh's shape after node loss, the survivor ``DeviceMesh`` and a state's
re-sharding onto it, on one rank and over 8 gloo processes (the
counterpart of the reference's 8 -> 6 -> 8 host-device round trip)."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.train.elastic import largest_submesh_shape as ref_submesh
from repro_torch.train import largest_submesh_shape, remesh, reshard_state

SRC = Path(__file__).resolve().parents[1] / "src"


def _monotone(fn):
    model, prev = 4, None
    for n in range(64, model - 1, -1):
        shape = fn(n, model)
        assert shape[-1] == model
        used = int(np.prod(shape))
        assert used <= n
        if prev is not None:
            assert used <= prev
        prev = used


def _keeps_model_axis(fn):
    assert fn(512, 16) == (2, 16, 16)
    shape = fn(511, 16)
    assert shape[-1] == 16 and np.prod(shape) <= 511
    assert fn(256, 16, prefer_pods=1) == (16, 16)
    with pytest.raises(ValueError):
        fn(8, 16)


def _model_axis_is_inviolable(fn):
    with pytest.raises(ValueError, match="cannot keep model axis"):
        fn(3, 4)


# the reference's test_submesh_* cases (tests/test_elastic.py) and
# test_largest_submesh_keeps_model_axis (tests/test_substrate.py)
SUBMESH_CASES = {
    "full_survivor_set": [((16, 4), (2, 2, 4)), ((512, 16), (2, 16, 16))],
    "data_axis_absorbs_partial_loss": [((11, 4), (2, 1, 4)),
                                       ((15, 4), (2, 1, 4))],
    "pod_axis_collapses_before_model": [((7, 4), (1, 4)),
                                        ((4, 4), (1, 4))],
    "prefer_pods": [((24, 4, 3), (3, 2, 4)), ((24, 4, 1), (6, 4))],
    "model_axis_is_inviolable": _model_axis_is_inviolable,
    "monotone_under_loss": _monotone,
    "keeps_model_axis": _keeps_model_axis,
}


@pytest.mark.parametrize("case", list(SUBMESH_CASES))
def test_submesh(case):
    spec = SUBMESH_CASES[case]
    if callable(spec):
        spec(largest_submesh_shape)
        spec(ref_submesh)
        return
    for args, want in spec:
        assert largest_submesh_shape(*args) == want
        assert ref_submesh(*args) == want


def test_submesh_matches_reference_exhaustively():
    for model in (1, 2, 4, 16):
        for pods in (1, 2, 3):
            for n in range(1, 601):
                try:
                    want = ref_submesh(n, model, pods)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)):
                        largest_submesh_shape(n, model, pods)
                    continue
                assert largest_submesh_shape(n, model, pods) == want


@pytest.fixture
def no_group():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_remesh_single_device(no_group):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            remesh([0], model_axis=1)     # the card unless asked
        assert not dist.is_initialized()
    mesh = remesh([0], model_axis=1, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)


def test_reshard_state_roundtrip_single_device(no_group):
    mesh = remesh([0], model_axis=1, device_type="cpu")
    state = {"w": np.arange(12.0).reshape(3, 4), "b": np.ones(4),
             "opt": {"m": torch.arange(6, dtype=torch.float32),
                     "count": np.int32(3)}}
    specs = {"w": (), "b": ("data",), "opt": {"m": ("model",),
                                               "count": ()}}
    out = reshard_state(state, mesh, specs)
    np.testing.assert_array_equal(out["w"].full_tensor().numpy(),
                                  state["w"])
    np.testing.assert_array_equal(out["b"].full_tensor().numpy(),
                                  state["b"])
    assert torch.equal(out["opt"]["m"].full_tensor(), state["opt"]["m"])
    assert int(out["opt"]["count"].full_tensor()) == 3


SHRINK_GROW = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.train import (largest_submesh_shape, remesh,
                                   reshard_state)

    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=8)
    MODEL = 2
    state = {"w": np.arange(64.0).reshape(8, 8), "step": np.float64(7.0)}
    specs = {"w": ("model", None), "step": ()}

    def host(st, mesh):
        # what a restart reads back: the members gather the state, rank
        # 0's copy reaches everyone (a checkpoint every rank reads)
        out = {}
        for k, v in st.items():
            full = v.full_tensor() if rank in mesh.mesh.flatten().tolist() \\
                else torch.zeros(v.shape, dtype=v.dtype)
            dist.broadcast(full, src=0)
            out[k] = full.numpy()
        return out

    # full fleet: (2, 2, 2)
    full = remesh(range(8), MODEL, device_type="cpu")
    assert full.mesh_dim_names == ("pod", "data", "model")
    st = reshard_state(state, full, specs)
    # two nodes die -> 6 survivors -> (2, 1, 2), data absorbed the loss
    shrunk_shape = largest_submesh_shape(6, MODEL)
    shrunk = remesh(range(6), MODEL, device_type="cpu")
    st = reshard_state(host(st, full), shrunk, specs)
    members = shrunk.mesh.flatten().tolist()
    # nodes return -> full mesh again; values survive the round trip
    grown = remesh(range(8), MODEL, device_type="cpu")
    st = reshard_state(host(st, shrunk), grown, specs)
    w = st["w"].full_tensor().numpy()
    rep = {"rank": rank, "shrunk_shape": list(shrunk_shape),
           "shrunk_ndev": len(members), "grown_ndev": grown.size(),
           "roundtrip_w": bool(np.array_equal(w, state["w"])),
           "roundtrip_step": float(st["step"].full_tensor()) == 7.0,
           "w_block": list(st["w"].to_local().shape)}
    print(json.dumps(rep), flush=True)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_shrink_grow_roundtrip_multidevice():
    """8 -> 6 -> 8 gloo ranks: the mesh shrinks along pods/data with the
    model axis fixed, and the state survives both reshardings bit for
    bit on every rank."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", SHRINK_GROW, str(r),
                               port], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(8)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    reps = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    for rep in reps:
        assert rep["shrunk_shape"] == [2, 1, 2]
        assert rep["shrunk_ndev"] == 4 and rep["grown_ndev"] == 8
        assert rep["roundtrip_w"] and rep["roundtrip_step"]
        assert rep["w_block"] == [4, 8]    # ("model", None): 2 blocks
