"""Training runtime: counterpart of ``repro/runtime/trainer.py``.  A train
step (loss, backward, optional int8 gradient compression, AdamW), async
checkpoints, exact resume and the straggler watchdog, on one device or on
a rank mesh (``mesh=``, dense family): each rank holds its part of every
leaf and of AdamW's moments by the reference's train rules (FSDP over
the data lines, a tensor split over 'model': ``sharding/train.py``),
trains on its data line's rows of each batch, and gathers what it needs
in rank order, so the loss, the gradient norm and the step time of its
``history`` are the same on every rank.

Fault-tolerance contract (held by ``tests/test_torch_trainer.py``):
  * a checkpoint at step N and the deterministic data give a resume whose
    losses equal an uninterrupted run's bit for bit (on the card with
    deterministic algorithms on);
  * the straggler watchdog flags slow steps from a z-score over recent
    step times, and the data iterator skips ahead in O(1).

The reference jit-compiles the step over a mesh; the port runs it eagerly
(no ``torch.compile``), and a step's time is taken after
``torch.cuda.synchronize()`` on the card, as the reference blocks on the
loss; on a mesh it is the slowest rank's.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.device import resolve_device
from repro_torch.launch import specs
from repro_torch.optim import compress as GC
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     init_adamw)
from repro_torch.sharding import rules as R
from repro_torch.sharding import train as ST
from repro_torch.tree import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = ""                 # "": a fresh directory in $TMPDIR
    async_ckpt: bool = True
    log_every: int = 10
    grad_compression: bool = False     # int8 + error feedback
    straggler_z: float = 3.0           # watchdog z-score threshold
    straggler_window: int = 20


class StepWatchdog:
    """Straggler detector over wall-clock step times: a step whose time is
    more than ``z`` standard deviations above the mean of the last
    ``window`` (once 5 are known) is flagged."""

    def __init__(self, z: float = 3.0, window: int = 20):
        self.z = z
        self.window = window
        self.times: list[float] = []
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        hist = self.times[-self.window:]
        is_straggler = False
        if len(hist) >= 5:
            mu = float(np.mean(hist))
            sd = float(np.std(hist)) + 1e-9
            is_straggler = (dt - mu) / sd > self.z
        if is_straggler:
            self.flagged.append(step)
        self.times.append(dt)
        return is_straggler


def make_loss_fn(model_mod, cfg: ModelConfig) -> Callable:
    def loss_fn(params, batch):
        return model_mod.lm_loss(params, cfg, batch)
    return loss_fn


def make_train_step(model_mod, cfg: ModelConfig, opt: AdamWConfig,
                    grad_compression: bool = False, mesh=None,
                    layout=None) -> Callable:
    """(params, opt_state, ef_state, batch) -> (params, opt_state,
    ef_state, metrics).  ``params``' leaves must require grad; they and
    the moments are updated in place.  A leaf the loss does not reach gets
    a zero gradient, as ``jax.grad`` gives it.  On a ``mesh`` the params
    are this rank's parts by ``layout`` and the batch is its data line's
    rows; the backward runs under the mesh too (the recomputed blocks
    gather again)."""
    loss_fn = make_loss_fn(model_mod, cfg)

    def step(params, opt_state: AdamWState, ef_state, batch):
        flat = flatten(params)
        leaves = [p for _, p in flat]
        with R.use_mesh(mesh), ST.use_layout(layout):
            loss, metrics = loss_fn(params, batch)
            grads = unflatten(params, torch.autograd.grad(
                loss, leaves, allow_unused=True, materialize_grads=True))
        if grad_compression:
            qgrads, ef_state = GC.compress_grads(grads, ef_state, layout)
            grads = GC.decompress_grads(qgrads)
        params, opt_state, om = adamw_update(opt, params, grads, opt_state,
                                             layout)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in dict(metrics, loss=loss, **om).items()}
        return params, opt_state, ef_state, metrics

    return step


def _trainable(params):
    """``params`` with every leaf a float tensor that requires grad."""
    for _, p in flatten(params):
        p.requires_grad_(True)
    return params


class Trainer:
    """The training loop of one device, or of this rank of ``mesh`` (a
    ``launch.mesh.RankMesh`` of more than one rank; dense family: the
    others raise).  ``device`` defaults to ``cuda`` and raises without a
    GPU unless it is ``"cpu"``."""

    def __init__(self, model_mod, cfg: ModelConfig, tcfg: TrainerConfig,
                 opt: AdamWConfig, data_cfg: DataConfig, device="cuda",
                 extra_batch: Optional[Callable[[int], dict]] = None,
                 mesh=None):
        self.model_mod = model_mod
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt = opt
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        # each leaf's part on this rank: the params', the moments' (placed
        # like their params) and the checkpoint's
        self.layout = (specs.param_shardings(cfg, self.mesh, "train")
                       if self.mesh is not None else None)
        self.data = DataIterator(data_cfg, device=self.device,
                                 mesh=self.mesh)
        self.extra_batch = extra_batch
        ckpt_dir = tcfg.ckpt_dir
        if not ckpt_dir:
            if self.mesh is not None:
                raise ValueError("training on a mesh needs a ckpt_dir every "
                                 "rank shares")
            ckpt_dir = tempfile.mkdtemp(prefix="repro_ckpt_")
        self.ckpt = CheckpointManager(ckpt_dir, host_id=data_cfg.host_id,
                                      n_hosts=data_cfg.n_hosts,
                                      mesh=self.mesh)
        self.watchdog = StepWatchdog(tcfg.straggler_z, tcfg.straggler_window)
        self.step_fn = None
        self.params = None
        self.opt_state = None
        self.ef_state = None
        self.global_step = 0
        self.history: list[dict] = []

    # ----------------------------------------------------------- setup ---
    def init_state(self, seed: int = 0) -> None:
        if self.mesh is not None:
            params = specs.train_params(self.cfg, self.mesh, seed,
                                        self.device)
        else:
            params = self.model_mod.init_lm(self.cfg, seed, self.device)
        self.params = _trainable(params)
        self.opt_state = init_adamw(self.params)
        self.ef_state = (GC.init_ef(self.params)
                         if self.tcfg.grad_compression else ())
        self.step_fn = make_train_step(self.model_mod, self.cfg, self.opt,
                                       self.tcfg.grad_compression,
                                       self.mesh, self.layout)

    def _state_layout(self):
        """The checkpointed state's layout (None off a mesh)."""
        if self.layout is None:
            return None
        return {"params": self.layout, "mu": self.layout,
                "nu": self.layout}

    def maybe_resume(self) -> bool:
        """Resume from the latest checkpoint if one exists."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        state = {"params": self.params, "mu": self.opt_state.mu,
                 "nu": self.opt_state.nu}
        restored, extra = self.ckpt.restore(state, latest,
                                            device=self.device,
                                            layout=self._state_layout())
        self.params = _trainable(restored["params"])
        self.opt_state = AdamWState(int(extra["opt_step"]), restored["mu"],
                                    restored["nu"])
        self.global_step = extra["global_step"]
        self.data.skip_to(self.global_step)
        return True

    def save(self, blocking: bool = False) -> None:
        state = {"params": self.params, "mu": self.opt_state.mu,
                 "nu": self.opt_state.nu}
        self.ckpt.save(self.global_step, state,
                       extra={"global_step": self.global_step,
                              "opt_step": int(self.opt_state.step)},
                       blocking=blocking or not self.tcfg.async_ckpt,
                       layout=self._state_layout())

    # ------------------------------------------------------------ train ---
    def run(self, steps: Optional[int] = None,
            fail_at: Optional[int] = None) -> list[dict]:
        """Train.  ``fail_at`` injects a crash (fault-tolerance tests)."""
        steps = steps if steps is not None else self.tcfg.steps
        target = self.global_step + steps
        while self.global_step < target:
            batch = next(self.data)
            if self.extra_batch:
                batch.update(self.extra_batch(self.global_step))
            t0 = time.perf_counter()
            self.params, self.opt_state, self.ef_state, metrics = \
                self.step_fn(self.params, self.opt_state, self.ef_state,
                             batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = self._slowest(time.perf_counter() - t0)
            self.global_step += 1
            self.watchdog.observe(self.global_step, dt)
            rec = {"step": self.global_step,
                   "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "time_s": dt}
            self.history.append(rec)
            if self.global_step % self.tcfg.ckpt_every == 0:
                self.save()
            if fail_at is not None and self.global_step >= fail_at:
                self.ckpt.wait()
                raise RuntimeError(f"injected failure at step "
                                   f"{self.global_step}")
        self.ckpt.wait()
        return self.history

    def _slowest(self, dt: float) -> float:
        """The step time of the slowest rank (``dt`` off a mesh)."""
        if self.mesh is None:
            return dt
        t = torch.tensor([dt], dtype=torch.float64)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t, group=self.mesh.host_group)
        return float(torch.cat(parts).max())
