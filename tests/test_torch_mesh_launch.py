"""The mesh launcher and the mesh server's rejections: ``Server(mesh=)``
refusing what it cannot place, ``--mesh``, a rank that fails or hangs
(``launch/ranks.py:run_ranks`` fails the run and stops every rank), the
serve CLI's ``--mesh-shape`` on spawned gloo ranks of the CPU, and ranks
that ``torchrun`` would start joining one mesh."""
import dataclasses
import json
import multiprocessing
import os
import socket
import subprocess
import sys

import pytest

from repro_torch.configs.registry import reduced_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import lm as tlm
from repro_torch.runtime.server import Server, ServeConfig

import _torch_mesh_ranks as MR
from test_torch_mesh_server import ARCH, B, _cfg


def test_rejections():
    """A mesh axis that does not divide the grid, a batch the data shards
    do not divide, one rank, a dense strategy, a whole tree where a rank's
    placed one is due, a family other than dense, ``--mesh`` (alone and
    with ``--mesh-shape``): all raise before any rank work."""
    cfg = reduced_config(ARCH)
    params = tlm.init_lm(cfg, 0, "cpu")
    mesh = make_mesh((2, 2), ("data", "model"))
    bad = _cfg("gather", ds=3, ms=2)
    with pytest.raises(ValueError, match="'data' axis"):
        Server(tlm, bad, ServeConfig(batch=6, max_len=32), params,
               device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="batch 3"):
        Server(tlm, _cfg("gather"), ServeConfig(batch=3, max_len=32),
               params, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="> 1 ranks"):
        Server(tlm, _cfg("gather"), ServeConfig(batch=B, max_len=32),
               params, device="cpu", mesh=make_mesh((1,), ("model",)))
    dense = cfg.replace(sparse=dataclasses.replace(cfg.sparse,
                                                   enabled=False))
    with pytest.raises(ValueError, match="mesh serving"):
        Server(tlm, dense, ServeConfig(batch=B, max_len=32), params,
               device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="hidden rows"):
        Server(tlm, _cfg("gather"), ServeConfig(batch=B, max_len=32),
               tlm.init_lm(_cfg("gather"), 0, "cpu"), device="cpu",
               mesh=mesh)
    moe = reduced_config("olmoe-1b-7b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Server(tlm, moe, ServeConfig(batch=B, max_len=32), {},
               device="cpu", mesh=mesh)
    base = ["--arch", ARCH, "--reduced", "--device", "cpu"]
    with pytest.raises(SystemExit, match="exclusive"):
        serve_cli.main(base + ["--mesh", "1x2", "--mesh-shape", "2"])
    with pytest.raises(NotImplementedError, match="not ported"):
        serve_cli.main(base + ["--mesh", "1x2"])


def test_failed_or_hung_rank_fails_the_run():
    """A rank that raises fails the run with its traceback; one that hangs
    past the timeout fails it too, and no rank outlives the run."""
    with pytest.raises(RuntimeError, match="failed on purpose"):
        run_ranks(MR.fail_on_rank1, (2,), ("model",), args=("raise",),
                  threads=1, timeout=120)
    with pytest.raises(TimeoutError, match="still running after 8 s"):
        run_ranks(MR.fail_on_rank1, (2,), ("model",), args=("hang",),
                  threads=1, timeout=8)
    assert not multiprocessing.active_children()


def test_serve_cli_mesh_shape(capsys):
    """``--mesh-shape 2x2`` on the CPU: rank 0's report with the mesh, the
    grid, every rank's launches, the backend, every rank's parameter
    bytes (a 'model' line's two ranks each hold less than one device, the
    'data' ranks the same), every rank's slot range (its 'data' line's two
    of the four slots) and KV bytes (its line's slots at its KV heads: a
    quarter of one device's) and no device peak; every request served."""
    check_serve_cli(capsys, "2x2")


def test_serve_cli_mesh_shape_2x1(capsys):
    """``--mesh-shape 2x1``: as 2x2, every rank holding the whole tree and
    half of one device's KV (its line's slots, every head)."""
    check_serve_cli(capsys, "2x1")


def check_serve_cli(capsys, shape: str) -> None:
    d, m = (int(v) for v in shape.split("x"))
    rep = serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--strategy", "gather", "--mesh-shape", shape,
                          "--batch", "4", "--requests", "4", "--max-new",
                          "4", "--controller"])
    assert rep["mesh"]["shape"] == [d, m]
    assert rep["mesh"]["grid"] == [d, m]
    assert len(rep["mesh"]["launches"]["per_rank"]) == d * m
    assert rep["mesh"]["backend"] == "gloo"
    held = rep["mesh"]["param_bytes"]
    assert len(set(held["per_rank"])) == 1
    if m > 1:
        assert held["one_device"] / 2 <= held["per_rank"][0] \
            < held["one_device"]
    else:
        assert held["per_rank"][0] == held["one_device"]
    slots = rep["mesh"]["slots"]
    assert [p["slots"] for p in slots["per_rank"]] == [
        [r // m * 2, r // m * 2 + 2] for r in range(d * m)]
    assert [p["kv_bytes"] for p in slots["per_rank"]] == [
        slots["one_device_kv_bytes"] // (d * m)] * (d * m)
    assert rep["mesh"]["peak_bytes"] == [None] * (d * m)
    assert rep["completed"] == 4 and rep["tokens"] == 16
    assert '"mesh"' in capsys.readouterr().out


def test_serve_cli_joins_torchrun_ranks():
    """Two processes started as torchrun starts them (``RANK``,
    ``WORLD_SIZE``, a localhost store) join one mesh through ``--mesh-shape
    2``: rank 0 prints the report, rank 1 prints nothing."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
            "--reduced", "--device", "cpu", "--strategy", "gather",
            "--mesh-shape", "2", "--batch", "2", "--requests", "2",
            "--max-new", "3"]
    procs = [subprocess.Popen(
        args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 OMP_NUM_THREADS="1")) for r in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    rep = json.loads(outs[0][0][outs[0][0].index("{"):])
    assert rep["mesh"]["shape"] == [2] and rep["completed"] == 2
    assert len(rep["mesh"]["launches"]["per_rank"]) == 2
    assert "{" not in outs[1][0]
