"""The training runtime through the port: ``checkpoint/manager.py``,
``runtime/trainer.py`` (against the JAX package's ``Trainer``),
``launch/train.py``, and the controller checkpoints of the serve path
(``save_controller``, ``restore_controller``, ``ServeConfig.
controller_ckpt``, ``--controller-ckpt``).

The trainers start from the reference's weights (``bridge``) and train
on the same synthetic batches.  The losses are held within 1e-5; the
params after k steps within ``2 * sum(lr_t) + 1e-6`` absolute: AdamW's
first steps move a parameter by about ``lr * sign(g)``, so an element
whose gradient the two sides put on opposite sides of 0 parts by 2 lr a
step (the count beyond 1e-6 is in the failure message, and at most 1 in
100 may be).  With int8 compression a code can flip the same way (x /
scale on either side of a rounding boundary), so the losses after the
first step are held within 1e-4 there.  A resume after an injected crash
is held bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced
from repro.core.predictor import AlphaSchedule as JAlphaSchedule
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import lm as jlm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime import controller as jctl
from repro.runtime import server as jserver
from repro.runtime import trainer as jtrainer
from repro.configs.base import ControllerConfig as JControllerConfig
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ControllerConfig
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.core.predictor import AlphaSchedule
from repro_torch.core.sparse_mlp import MLP_STAT_KEYS, SHARD_STAT_KEY
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, cosine_lr,
                                    init_adamw)
from repro_torch.optim.compress import init_ef
from repro_torch.runtime import controller as tctl
from repro_torch.runtime import trainer as ttrainer
from repro_torch.runtime.server import Request, Server, ServeConfig
from repro_torch.tree import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(lr_peak=1e-3, lr_min=1e-4, warmup_steps=1, decay_steps=10)
STEPS = 3
COMPRESSED_LOSS_TOL = 1e-4


# ------------------------------------------------------------ checkpoint --

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g),
            "blocks": [{"s": torch.randn(5, generator=g).to(torch.bfloat16),
                        "q": torch.randint(-127, 128, (6,), generator=g,
                                           dtype=torch.int8)},
                       {"s": torch.randn(5, generator=g).to(torch.bfloat16),
                        "q": torch.randint(-127, 128, (6,), generator=g,
                                           dtype=torch.int8)}],
            "count": torch.tensor([7, -3], dtype=torch.int32),
            "host": np.arange(4, dtype=np.float32)}


def _equal(a, b) -> None:
    fa, fb = flatten(a), flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert type(x) is type(y), path
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype, path
            assert torch.equal(x, y), path
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("blocking", [True, False])
def test_checkpoint_roundtrip(tmp_path, blocking):
    m = CheckpointManager(str(tmp_path))
    tree = _tree()
    m.save(5, tree, extra={"note": 1}, blocking=blocking)
    m.wait()
    got, extra = m.restore(tree)
    assert extra == {"note": 1}
    _equal(got, tree)
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        man = json.load(f)
    assert man["paths"][0] == "blocks/0/q"
    assert man["dtypes"][man["paths"].index("blocks/1/s")] == "bfloat16"
    with np.load(tmp_path / "step_00000005" / "shard_0.npz") as data:
        bits = data[str(man["paths"].index("blocks/1/s"))]
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(
        bits, tree["blocks"][1]["s"].view(torch.int16).numpy().view(
            np.uint16))


def test_async_checkpoint_keeps_pre_step_values(tmp_path, monkeypatch):
    """An async save of CPU params holds the values they had at ``save``:
    the writer thread is held until an AdamW step has updated the params
    in place, and the checkpoint still restores the pre-step tree."""
    from repro_torch.checkpoint import manager as mgr_mod
    released, savez = threading.Event(), np.savez

    def held_savez(*args, **kw):
        assert released.wait(30), "the step never released the writer"
        savez(*args, **kw)
    monkeypatch.setattr(mgr_mod.np, "savez", held_savez)
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 4, generator=g),
              "blocks": [{"s": torch.randn(5, generator=g)}]}
    want = {path: leaf.clone() for path, leaf in flatten(params)}
    m = CheckpointManager(str(tmp_path))
    m.save(1, params, blocking=False)
    grads = {"w": torch.ones(3, 4), "blocks": [{"s": torch.ones(5)}]}
    adamw_update(AdamWConfig(lr_peak=0.1, warmup_steps=0), params, grads,
                 init_adamw(params))
    assert any(not torch.equal(leaf, want[path])
               for path, leaf in flatten(params)), "the step moved nothing"
    released.set()
    m.wait()
    got, _ = m.restore(params)
    for path, leaf in flatten(got):
        assert torch.equal(leaf, want[path]), path


def test_checkpoint_latest_gc_and_tmp_ignored(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.zeros(2)}
    assert m.latest_step() is None
    for s in (1, 2, 3, 4):
        m.save(s, tree, blocking=s % 2 == 0)
        m.wait()
    os.makedirs(tmp_path / "step_00000009.tmp_x")
    assert m.latest_step() == 4
    assert m.all_steps() == [3, 4]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


def test_checkpoint_rejects_other_trees(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"a": torch.zeros(2), "b": [torch.zeros(3)]})
    with pytest.raises(ValueError, match="mismatch"):
        m.restore({"zzz": torch.zeros(2), "b": [torch.zeros(3)]})
    with pytest.raises(ValueError, match="mismatch"):
        m.restore({"a": torch.zeros(2), "b": [torch.zeros(3),
                                              torch.zeros(3)]})
    with pytest.raises(ValueError, match="shape mismatch"):
        m.restore({"a": torch.zeros(3), "b": [torch.zeros(3)]})
    got, _ = m.restore({"a": torch.zeros(3), "b": [torch.zeros(3)]},
                       strict_shapes=False)
    assert got["a"].shape == (2,)


def test_checkpoint_restores_dtype_and_device_of_the_like(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"a": torch.arange(4.0)})
    got, _ = m.restore({"a": torch.zeros(4, dtype=torch.float64)},
                       device="cpu")
    assert got["a"].dtype == torch.float64
    assert got["a"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_async_write_error_surfaces_on_wait(tmp_path):
    m = CheckpointManager(str(tmp_path / "gone"))
    os.rmdir(tmp_path / "gone")           # the write's directory vanishes
    m.save(1, {"a": torch.zeros(2)}, blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        m.wait()
    m.wait()                              # reported once


# ------------------------------------------------- trainer vs reference --

def _trainers(arch: str, compress: bool, tmp):
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    dkw = dict(vocab=jcfg.vocab, seq_len=16, global_batch=2)
    tkw = dict(steps=STEPS, ckpt_every=100, grad_compression=compress)
    jt = jtrainer.Trainer(jlm, jcfg, jtrainer.TrainerConfig(
        ckpt_dir=str(tmp / "j"), **tkw), JAdamWConfig(**OPT),
        JDataConfig(**dkw))
    jt.init_state(seed=0)
    tt = ttrainer.Trainer(lm, tcfg, ttrainer.TrainerConfig(
        ckpt_dir=str(tmp / "t"), **tkw), AdamWConfig(**OPT),
        DataConfig(**dkw), device="cpu")
    tt.init_state(seed=0)
    tree = jax.tree.map(np.asarray, jt.params)
    tt.params = ttrainer._trainable(bridge.params_from_numpy(tree, tcfg,
                                                             "cpu"))
    tt.opt_state = init_adamw(tt.params)
    tt.ef_state = init_ef(tt.params) if compress else ()
    return jt, tt, tcfg


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ["prosparse-llama2-7b", "olmoe-1b-7b"])
def test_trainer_matches_reference(arch, compress, tmp_path):
    jt, tt, tcfg = _trainers(arch, compress, tmp_path)
    jh = jt.run()
    th = tt.run()
    assert [h["step"] for h in th] == list(range(1, STEPS + 1))
    # the first step's loss is the weights' own; later ones follow the
    # updates, where an int8 code that the two sides put on either side
    # of a rounding boundary (1 of ~148k at step 1 here) moves its
    # parameter by lr
    tol = [1e-5] + [COMPRESSED_LOSS_TOL if compress else 1e-5] * (STEPS - 1)
    for t, j, a in zip(th, jh, tol):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=0, atol=a)
    np.testing.assert_allclose([h["grad_norm"] for h in th],
                               [h["grad_norm"] for h in jh], rtol=1e-4)
    bound = 2 * sum(float(cosine_lr(AdamWConfig(**OPT), s))
                    for s in range(1, STEPS + 1)) + 1e-6
    want = jax.tree.map(np.asarray, jt.params)
    got = bridge.params_to_numpy(tt.params, tcfg)
    gaps = [np.abs(g - w) for g, w in zip(jax.tree.leaves(got),
                                          jax.tree.leaves(want))]
    beyond = sum(int((d > 1e-6).sum()) for d in gaps)
    total = sum(d.size for d in gaps)
    worst = max(float(d.max()) for d in gaps)
    assert worst <= bound, (worst, bound, f"{beyond}/{total} beyond 1e-6")
    assert beyond <= total // 100, f"{beyond}/{total} beyond 1e-6"
    assert tt.opt_state.step == int(jt.opt_state.step) == STEPS


TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128, loss_chunk=64)


def _tiny_trainer(tmp, **kw):
    cfg = t_reduced("prosparse-llama2-7b").replace(**TINY)
    tcfg = ttrainer.TrainerConfig(steps=6, ckpt_every=3, ckpt_dir=str(tmp),
                                  log_every=100, **kw)
    t = ttrainer.Trainer(lm, cfg, tcfg, AdamWConfig(lr_peak=1e-3,
                                                    warmup_steps=2,
                                                    decay_steps=50),
                         DataConfig(vocab=128, seq_len=16, global_batch=4),
                         device="cpu")
    t.init_state(seed=0)
    return t


@pytest.mark.parametrize("async_ckpt", [True, False])
def test_bitwise_resume_after_crash(tmp_path, async_ckpt):
    """Crash at step 5, resume from the checkpoint of step 3: steps 4-6
    equal an uninterrupted run's bit for bit."""
    t1 = _tiny_trainer(tmp_path / "a", async_ckpt=async_ckpt)
    with pytest.raises(RuntimeError, match="injected failure"):
        t1.run(steps=10, fail_at=5)
    t2 = _tiny_trainer(tmp_path / "a", async_ckpt=async_ckpt)
    assert t2.maybe_resume()
    assert t2.global_step == 3 and t2.data.step == 3
    assert t2.opt_state.step == 3
    t2.run(steps=3)
    t3 = _tiny_trainer(tmp_path / "b", async_ckpt=async_ckpt)
    t3.run(steps=6)
    ref = {h["step"]: h["loss"] for h in t3.history}
    got = {h["step"]: h["loss"] for h in t2.history}
    assert [got[s] for s in (4, 5, 6)] == [ref[s] for s in (4, 5, 6)]
    for (path, a), (_, b) in zip(flatten(t2.params), flatten(t3.params)):
        assert torch.equal(a, b), path


def test_resume_without_checkpoint_is_fresh(tmp_path):
    t = _tiny_trainer(tmp_path)
    assert not t.maybe_resume()
    hist = t.run(steps=2)
    assert np.isfinite([h["loss"] for h in hist]).all()


def test_watchdog_flags_outlier():
    for wd in (ttrainer.StepWatchdog(z=3.0, window=10),
               jtrainer.StepWatchdog(z=3.0, window=10)):
        for i in range(10):
            wd.observe(i, 0.10 + 0.001 * (i % 3))
        assert wd.observe(10, 1.0) is True
        assert wd.observe(11, 0.10) is False
        assert wd.flagged == [10]


def test_train_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "prosparse-llama2-7b", "--reduced", "--device", "cpu", "--steps",
         "3", "--global-batch", "2", "--seq", "16", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)
    assert out.returncode == 0, out.stderr
    steps = [json.loads(line)["step"] for line in out.stdout.splitlines()
             if line.startswith("{")]
    assert steps[:3] == [1, 2, 3]
    assert "straggler steps flagged" in out.stdout
    assert os.path.isdir(tmp_path / "step_00000003")


def test_checkpoint_dirs_are_never_shared(tmp_path, monkeypatch):
    """Two Trainers left to the default each get a fresh directory under
    $TMPDIR, and the train CLI will not run without ``--ckpt-dir``."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfg = t_reduced("prosparse-llama2-7b")
    dirs = [ttrainer.Trainer(lm, cfg, ttrainer.TrainerConfig(),
                             AdamWConfig(), DataConfig(
                                 vocab=cfg.vocab, seq_len=8, global_batch=2),
                             device="cpu").ckpt.dir for _ in range(2)]
    assert dirs[0] != dirs[1]
    assert all(os.path.dirname(d) == str(tmp_path) for d in dirs)
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main(["--arch", "prosparse-llama2-7b", "--reduced",
                    "--device", "cpu"])


def test_train_cli_refuses_a_mesh(tmp_path):
    """A mesh trains the dense family only (``tests/
    test_torch_mesh_train.py`` trains it): another family raises, naming
    itself, before any rank starts; a mesh of four axes is refused."""
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="'xlstm'.*item 15.5"):
        train.main(["--arch", "xlstm-125m", "--reduced",
                    "--device", "cpu", "--mesh", "2x2",
                    "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        train.main(["--arch", "prosparse-llama2-7b", "--reduced",
                    "--device", "cpu", "--mesh", "2x2x2x2",
                    "--ckpt-dir", str(tmp_path)])


# ------------------------------------------------- controller checkpoints --

def _stats(rng, shape):
    return {k: rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
            for k in MLP_STAT_KEYS}


def test_controller_roundtrip_reproduces_report(tmp_path):
    cc = ControllerConfig(enabled=True, audit_period=3)
    ctl = tctl.AlphaController(cc, AlphaSchedule(), 4)
    rng = np.random.default_rng(0)
    for i in range(5):
        ctl.observe(_stats(rng, (4,)), audit=i == 2)
    mgr = CheckpointManager(str(tmp_path))
    assert tctl.save_controller(ctl, mgr) == 5
    new = tctl.AlphaController(cc, AlphaSchedule(), 4)
    assert tctl.restore_controller(new, mgr)
    assert new.report() == ctl.report()
    np.testing.assert_array_equal(new.alphas(), ctl.alphas())
    fresh = tctl.AlphaController(cc, AlphaSchedule(), 4)
    assert not tctl.restore_controller(
        fresh, CheckpointManager(str(tmp_path / "none")))


def _shard_controllers(ms: int):
    """The reference's and the port's DistributedController over 3 layers
    and ``ms`` model shards, fed the same shard telemetry."""
    out = []
    for mod, ccfg, sched in ((jctl, JControllerConfig, JAlphaSchedule),
                             (tctl, ControllerConfig, AlphaSchedule)):
        ctl = mod.DistributedController(mod.AlphaController(
            ccfg(enabled=True, ema=0.5), sched(), 3), ms)
        rng = np.random.default_rng(ms)
        for _ in range(3):
            stats = _stats(rng, (3, 2))
            stats[SHARD_STAT_KEY] = rng.uniform(
                0.1, 0.6, (3, 2, ms)).astype(np.float32)
            rest = ctl.consume_shard_stats(stats)
            ctl.observe({k: v.mean(-1) for k, v in rest.items()})
        out.append(ctl)
    return out


def test_distributed_controller_regrid_as_reference(tmp_path):
    """A checkpoint of a 2-shard controller restored on 4 model shards:
    the shard EMAs are remapped with a warning, as the reference's, to the
    reference's values."""
    jc, tc = _shard_controllers(2)
    np.testing.assert_array_equal(tc.shard_density_ema, jc.shard_density_ema)
    jctl.save_controller(jc, JManager(str(tmp_path / "j")))
    tctl.save_controller(tc, CheckpointManager(str(tmp_path / "t")))
    jn = jctl.DistributedController(jctl.AlphaController(
        JControllerConfig(enabled=True, ema=0.5), JAlphaSchedule(), 3), 4)
    tn = tctl.DistributedController(tctl.AlphaController(
        ControllerConfig(enabled=True, ema=0.5), AlphaSchedule(), 3), 4)
    with pytest.warns(UserWarning, match="remapped onto"):
        assert jctl.restore_controller(jn, JManager(str(tmp_path / "j")))
    with pytest.warns(UserWarning, match="remapped onto"):
        assert tctl.restore_controller(tn, CheckpointManager(
            str(tmp_path / "t")))
    assert tn.stats_regrids == jn.stats_regrids == 1
    assert tn.shard_density_ema.shape == (3, 4)
    for name in ("shard_density_ema", "shard_union_ema"):
        np.testing.assert_allclose(getattr(tn, name), getattr(jn, name),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tn.alphas(), jn.alphas())
    assert tn._shard_steps == jn._shard_steps
    # the same grid restores silently
    same = tctl.DistributedController(tctl.AlphaController(
        ControllerConfig(enabled=True, ema=0.5), AlphaSchedule(), 3), 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tctl.restore_controller(same, CheckpointManager(
            str(tmp_path / "t")))
    np.testing.assert_array_equal(same.shard_density_ema,
                                  tc.shard_density_ema)


def _server_cfg():
    cfg = t_reduced("prosparse-llama2-7b")
    return cfg.replace(sparse=dataclasses.replace(
        cfg.sparse, strategy="masked", group_size=1))


def _reqs(vocab, n=3):
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, vocab, size=6),
                    max_new=4) for i in range(n)]


def test_server_restart_resumes_controller(tmp_path):
    assert ServeConfig().controller_ckpt == \
        jserver.ServeConfig().controller_ckpt == ""
    cfg = _server_cfg()
    params = lm.init_lm(cfg, 0, device="cpu")
    scfg = ServeConfig(batch=2, max_len=32, controller=ControllerConfig(
        enabled=True, target_density=0.2, audit_period=3),
        controller_ckpt=str(tmp_path))
    srv1 = Server(lm, cfg, scfg, params, device="cpu")
    srv1.serve(_reqs(cfg.vocab))
    steps1 = srv1.controller.state.steps
    assert steps1 > 0
    assert CheckpointManager(str(tmp_path)).latest_step() == steps1
    srv2 = Server(lm, cfg, scfg, params, device="cpu")      # a restart
    assert srv2.controller.state.steps == steps1
    np.testing.assert_array_equal(srv2.controller.alphas(),
                                  srv1.controller.alphas())
    np.testing.assert_array_equal(srv2.controller.state.fn_ema,
                                  srv1.controller.state.fn_ema)
    srv2.serve(_reqs(cfg.vocab))
    assert srv2.controller.state.steps > steps1
    assert srv2.save_controller() == srv2.controller.state.steps
    off = Server(lm, cfg, ServeConfig(batch=2, max_len=32), params,
                 device="cpu")
    assert off.save_controller() is None


def test_serve_cli_controller_ckpt(tmp_path, capsys):
    argv = ["--arch", "prosparse-llama2-7b", "--reduced", "--device", "cpu",
            "--strategy", "gather", "--controller", "--requests", "2",
            "--batch", "2", "--max-new", "3", "--prompt-len", "6",
            "--max-len", "32", "--controller-ckpt", str(tmp_path)]
    serve_cli.main(argv)
    first = CheckpointManager(str(tmp_path)).latest_step()
    assert first is not None and first > 0
    serve_cli.main(argv)
    assert CheckpointManager(str(tmp_path)).latest_step() > first
    capsys.readouterr()


def test_trainer_defaults_to_the_card(tmp_path):
    """Without a GPU the Trainer and the train CLI raise unless asked for
    ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = t_reduced("prosparse-llama2-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.Trainer(lm, cfg, ttrainer.TrainerConfig(
            ckpt_dir=str(tmp_path)), AdamWConfig(), DataConfig(
            vocab=cfg.vocab, seq_len=8, global_batch=2))
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "prosparse-llama2-7b", "--reduced",
                    "--ckpt-dir", str(tmp_path)])
