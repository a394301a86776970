"""Start the local ranks of a rank mesh (``launch/mesh.py``) and run one
function on each.

    outs = run_ranks(fn, (2, 2), ("data", "model"), args=(...,),
                     device="cuda")

calls ``fn(mesh, device, *args)`` on every rank and returns the ranks'
return values in rank order.  It starts prod(shape) processes with the
``spawn`` start method, or, in a process that ``torchrun`` started (the
``RANK`` and ``WORLD_SIZE`` variables), joins its ranks and runs ``fn`` on
this one.  Spawned ranks meet through a ``FileStore`` in a temporary
directory.

The backend is chosen by a rule, and printed: ``nccl`` when every rank has
a card of its own (device cuda and no more ranks than cards), ``gloo``
when ranks share a card (rank r on card r % count: all on card 0 of a
one-card machine) or run on the CPU.  gloo carries CUDA tensors through
host memory; NCCL refuses two ranks of one communicator on one card.
``backend=`` overrides the rule for a run that asks for one backend.

The CUDA kernels are built in the parent before the ranks start, so ranks
never race on ``build/``.  ``timeout`` bounds every collective (the
process group's) and the whole run: a rank that fails or hangs fails the
run, which stops every rank it started.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch.mesh import make_mesh


def choose_backend(world: int, device: str) -> tuple[str, str]:
    """(backend, reason) for ``world`` ranks on ``device``."""
    if torch.device(device).type != "cuda":
        return "gloo", f"{world} ranks on the CPU"
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", f"{world} ranks, a card each of {cards}"
    return "gloo", (f"{world} ranks share {cards} card(s): NCCL takes one "
                    "rank of a communicator a card")


def rank_device(rank: int, device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def is_rank_zero() -> bool:
    """False in a process that torchrun started as a rank other than 0."""
    return int(os.environ.get("RANK", "0")) == 0


def _init(backend: str, rank: int, world: int, dev: torch.device,
          timeout: float, store=None) -> None:
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"store": store} if store is not None else {"init_method": "env://"}
    dist.init_process_group(
        backend, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout), **kw)


def _rank_main(rank: int, world: int, tmp: str, backend: str, shape: tuple,
               axes: tuple, device: str, timeout: float,
               threads: int) -> None:
    """A spawned rank: join the group, run the function ``tmp`` holds,
    leave its return value (or its traceback) in ``tmp``."""
    try:
        # the function and its arguments come from a file: through the
        # spawn pipe, each rank's start would wait for the last one's
        # unpickling (and its imports)
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(threads)
        # the ranks of one machine talk over its loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dev = rank_device(rank, device)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        _init(backend, rank, world, dev, timeout, store)
        mesh = make_mesh(shape, axes)
        # no rank leaves before every rank has connected every line's
        # group: a rank that returns at once would close its end of a
        # group another rank is still connecting to
        store.set(f"meshed{rank}", "1")
        store.wait([f"meshed{r}" for r in range(world)])
        out = fn(mesh, dev, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, shape: tuple, axes: tuple, *, args: tuple = (),
              device: str = "cpu", timeout: float = 600.0,
              threads: int = 0, backend: str = "") -> list:
    """``fn(mesh, device, *args)`` on every rank of a ``shape`` mesh over
    ``axes``; the ranks' return values (picklable) in rank order.
    ``threads`` sets each spawned rank's ``torch.set_num_threads`` (0: the
    machine's cores split between the ranks; more threads than cores spin
    against each other in every collective).  Raises if any rank fails,
    and ``TimeoutError`` past ``timeout`` seconds."""
    world = math.prod(shape)
    rule, why = choose_backend(world, device)
    if backend and backend != rule:
        why = f"asked for, where the rule gives {rule} ({why})"
    backend = backend or rule
    if is_rank_zero():
        print(f"[ranks] mesh {tuple(shape)} over {tuple(axes)}: backend "
              f"{backend} ({why})", flush=True)
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build
        build.build()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _join(fn, shape, axes, args, device, timeout, backend, world)
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    tmp = tempfile.mkdtemp(prefix="repro_ranks_")
    with open(os.path.join(tmp, "call.pkl"), "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, tmp, backend, tuple(shape), tuple(axes), device, timeout,
        threads)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0]} failed:\n"
                                   + _error(tmp, failed[0], procs))
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {[r for r, p in enumerate(procs) if p.is_alive()]}"
                    f" still running after {timeout:.0f} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"rank {failed[0]} failed:\n"
                               + _error(tmp, failed[0], procs))
        outs = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def _error(tmp: str, rank: int, procs: list) -> str:
    path = os.path.join(tmp, f"rank{rank}.err")
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return f"exit code {procs[rank].exitcode}, no traceback"


def _join(fn, shape, axes, args, device, timeout, backend, world) -> list:
    """In a torchrun rank: run ``fn`` on this rank; every rank's return
    value, gathered."""
    if int(os.environ["WORLD_SIZE"]) != world:
        raise ValueError(f"mesh {tuple(shape)} needs {world} ranks, torchrun "
                         f"started {os.environ['WORLD_SIZE']}")
    rank = int(os.environ["RANK"])
    dev = rank_device(int(os.environ.get("LOCAL_RANK", rank)), device)
    _init(backend, rank, world, dev, timeout)
    try:
        out = fn(make_mesh(shape, axes), dev, *args)
        outs = [None] * world
        dist.all_gather_object(outs, out)
        return outs
    finally:
        dist.destroy_process_group()
