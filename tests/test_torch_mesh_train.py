"""Training over a (data, model) mesh of ranks (``sharding/train.py``,
``launch/specs.py:param_shardings``, the combines' backwards in
``sharding/rules.py``, ``Trainer(mesh=)``, ``launch.train --mesh``)
against the JAX package.

In one process: the port's train-mode ``param_spec`` against the JAX
package's ``param_spec(path, shape, "train", mesh)`` for every leaf of
every dense arch on host-device meshes 2x2, 4x1, 1x4 and 2x1x2, and
every rank's placed leaf against the JAX package's slice of it under
that spec (``NamedSharding.devices_indices_map``), the K/V leaves of an
arch whose KV heads do not split over 'model' being the documented
difference (a rank keeps the one KV head its query heads read).

On gloo ranks of the CPU (``tests/_torch_mesh_ranks.py:train_suite``, one
spawn a mesh): reduced dense archs (MHA, GQA with qk-norm, MQA, QKV
biases, gemma2's tied table, softcaps and post-norms), their norm scales
and biases drawn non-zero, with ``loss_chunk=6`` and remat on for half of
them.  The loss of every rank equal to rank 0's bit for bit and within
1e-5 of the JAX package's ``jax.value_and_grad(lm_loss)`` on the same
weights and batch (B=4, S=16), every gradient leaf within 1e-4 x the
reference leaf's largest magnitude (the one-process tolerances of
``test_torch_train_models.py``); 2x1x2 bitwise
2x2.  On 2x2 two ``Trainer`` steps with and without int8 compression
against the JAX ``Trainer`` run inside a 2x2 host-device mesh; the int8
codes and scales of a gradient tree placed on the ranks equal one
process's bit for bit; a checkpoint written on 2x2 restored bitwise on
1x2 and on one process, whose continued losses are within 1e-5 of the
uninterrupted run's.  ``launch.train --mesh 2x2 --device cpu`` end to
end, and a non-dense family raising under ``--mesh``.
"""
import functools
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from repro.configs.registry import reduced_config as j_reduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.launch.specs import model_module as j_module
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime import trainer as jtrainer
from repro.sharding import rules as JR
from repro_torch import bridge
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.launch.mesh import RankMesh, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.specs import param_shapes
from repro_torch.models import lm as tlm
from repro_torch.optim import compress as GC
from repro_torch.runtime import trainer as ttrainer
from repro_torch.sharding import rules as TR
from repro_torch.sharding import train as ST
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import flatten, tree_map

import _torch_mesh_ranks as MR
from test_torch_train_models import _perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4                       # x max |reference leaf|
B, S = 4, 16
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# (arch, remat): MHA, GQA with qk-norm (2 KV heads: shared by pairs of 4
# 'model' ranks), MQA, QKV biases, gemma2
ARCHS = (("prosparse-llama2-7b", True), ("qwen3-8b", True),
         ("granite-34b", False), ("qwen1.5-32b", False),
         ("gemma2-2b", True))
KV_LEAVES = ("wk", "wv", "bk", "bv")
OPT = dict(lr_peak=1e-3, lr_min=1e-4, warmup_steps=1, decay_steps=10)


def cfgs(arch: str, remat: bool):
    return tuple(reduced(arch).replace(loss_chunk=6, remat=remat)
                 for reduced in (j_reduced, t_reduced))


@functools.lru_cache(maxsize=None)
def weights(arch: str) -> dict:
    jcfg, _ = cfgs(arch, False)
    tree = jax.tree.map(np.asarray, j_module(jcfg).init_lm(
        jax.random.PRNGKey(0), jcfg))
    _perturb(tree, np.random.default_rng(1))
    return tree


def batch(cfg) -> dict:
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    out["labels"][0, :3] = -100
    out["labels"][3, -2] = -100
    return out


@functools.lru_cache(maxsize=None)
def reference(arch: str, remat: bool):
    """(loss, numpy gradient tree) of the JAX package."""
    jcfg, _ = cfgs(arch, remat)
    mod = j_module(jcfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, bb: mod.lm_loss(p, jcfg, bb), has_aux=True))(
        jax.tree.map(jnp.asarray, weights(arch)),
        {k: jnp.asarray(v) for k, v in batch(jcfg).items()})
    return float(loss), jax.tree.map(np.asarray, grads)


def _grad_cases():
    return [(cfgs(a, r)[1], weights(a), batch(cfgs(a, r)[1]))
            for a, r in ARCHS]


def _check_grads(arch, remat, got_loss, got_tree) -> None:
    want_loss, want = reference(arch, remat)
    np.testing.assert_allclose(got_loss, want_loss, rtol=0, atol=LOSS_TOL)
    got = bridge.params_to_numpy(got_tree, cfgs(arch, remat)[1])
    w_paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for (path, w), g in zip(w_paths, jax.tree.leaves(got)):
        name = f"{arch} {jax.tree_util.keystr(path)}"
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * scale if scale else 1e-9,
                                   err_msg=name)


def _check_suite_grads(outs: list, mesh_id: str) -> list:
    """On ``mesh_id``: every rank's loss bitwise rank 0's; each case
    against the JAX package; rank 0's (loss, gradients) per case."""
    for i, (arch, remat) in enumerate(ARCHS):
        losses = {o["grads"][mesh_id][i][0] for o in outs}
        assert len(losses) == 1, (arch, losses)
        _check_grads(arch, remat, *outs[0]["grads"][mesh_id][i])
    return outs[0]["grads"][mesh_id]


# ------------------------------------------------------------ the rules --

def _ref_path(path: str) -> tuple:
    parts = path.split("/")
    if parts[0] == "blocks":
        return "/".join(["blocks"] + parts[2:]), int(parts[1])
    return path, None


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_train_specs_and_slices_match_reference(mesh_id):
    """The train-mode ``param_spec`` equals the JAX package's for every
    leaf of every dense arch (stacked leaves' leading None dropped); each
    rank's placed leaf is the JAX package's slice under it but the K/V
    leaves where the KV heads do not split, which hold the one KV head the
    rank reads, sliced over the data lines by the same spec."""
    shape, axes = MESHES[mesh_id]
    jm = j_make_mesh(shape, axes)
    tm = make_mesh(shape, axes)
    m = tm.axis_size("model")
    for arch, _ in ARCHS:
        _, cfg = cfgs(arch, False)
        ref = weights(arch)
        whole = bridge.params_from_numpy(ref, cfg, "cpu")
        flat, _ = jax.tree_util.tree_flatten_with_path(
            JR.param_specs(ref, "train", jm),
            is_leaf=lambda s: isinstance(s, PartitionSpec))
        ref_specs = {JR._path_str(kp): tuple(spec) for kp, spec in flat}
        ref_leaves = dict(_leaves(ref))
        for path, leaf in _leaves(whole):
            rpath, layer = _ref_path(path)
            spec = ref_specs[rpath][0 if layer is None else 1:]
            assert TR.param_spec(path, tuple(leaf.shape), tm,
                                 "train") == spec, (arch, path)
        kv_split = cfg.n_kv_heads % m == 0
        hd = cfg.resolved_head_dim
        for r in range(tm.size):
            rm = RankMesh(axes, shape, r)
            dev = jm.devices[tuple(rm.coords()[a] for a in axes)]
            placed = ST.place_train_params(whole, rm, cfg)
            for path, leaf in _leaves(placed):
                rpath, layer = _ref_path(path)
                full = ref_leaves[rpath]
                spec = JR.param_spec(rpath, full.shape, "train", jm)
                idx = NamedSharding(jm, spec).devices_indices_map(
                    full.shape)[dev]
                if path.rsplit("/", 1)[-1] in KV_LEAVES and not kv_split \
                        and m > 1:
                    # the rank's KV head, whole over 'model', then the
                    # spec's data slice
                    head = (rm.axis_index("model") // (m // cfg.n_kv_heads)
                            if m % cfg.n_kv_heads == 0 else 0)
                    one = full if layer is None else full[layer]
                    one = one[..., head * hd:(head + 1) * hd]
                    idx = tuple(slice(None) if i == one.ndim - 1 + (
                        layer is not None) else s for i, s in enumerate(idx))
                    want = one[idx[1:] if layer is not None else idx]
                else:
                    want = full[idx]
                    want = want if layer is None else want[layer]
                np.testing.assert_array_equal(
                    bridge._numpy(leaf), want,
                    err_msg=f"{arch} {mesh_id} rank {r} {path}")


def test_layout_and_opt_specs():
    """``param_shardings``: each leaf's whole extent, every rank's part
    (their parts cover the leaf once per replica), owners; the moments
    placed like the params; a non-dense family refused."""
    from repro_torch.launch import specs
    _, cfg = cfgs("qwen3-8b", False)
    shape, axes = MESHES["2x2"]
    layouts = [specs.param_shardings(cfg, RankMesh(axes, shape, r))
               for r in range(4)]
    whole = param_shapes(cfg)
    for (path, w), *shards in zip(flatten(whole),
                                  *(flatten(lay) for lay in layouts)):
        shards = [s for _, s in shards]
        assert all(s.whole == tuple(w.shape) for s in shards), path
        assert [s.index for s in shards] == list(shards[0].indices), path
        owned = sum(int(np.prod(s.shape)) for s in shards if s.owner)
        assert owned == w.numel(), path
    st = specs.opt_state_specs(layouts[0])
    assert st.mu is layouts[0] and st.nu is layouts[0] and st.step is None
    with pytest.raises(NotImplementedError, match="'xlstm'"):
        specs.param_shardings(t_reduced("xlstm-125m"),
                              RankMesh(axes, shape, 0))


# ------------------------------------------------------- gloo ranks: 2x2 --

@functools.lru_cache(maxsize=None)
def _trainer_reference(arch: str, compress: bool, steps: int):
    """The JAX ``Trainer``'s history and params after ``steps`` steps,
    run inside a 2x2 host-device mesh, and its initial weights."""
    jcfg = j_reduced(arch)
    jm = j_make_mesh((2, 2), ("data", "model"))
    with jm, tempfile.TemporaryDirectory() as tmp:
        jt = jtrainer.Trainer(
            j_module(jcfg), jcfg, jtrainer.TrainerConfig(
                steps=steps, ckpt_every=100, ckpt_dir=tmp,
                grad_compression=compress),
            JAdamWConfig(**OPT),
            JDataConfig(vocab=jcfg.vocab, seq_len=S, global_batch=B),
            mesh=jm)
        jt.init_state(seed=0)
        w0 = jax.tree.map(np.asarray, jt.params)
        hist = jt.run()
    return w0, hist, jax.tree.map(np.asarray, jt.params)


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    """One spawn of four ranks: the gradient cases on every mesh of
    ``MESHES``, and on 2x2 the codes of a placed gradient tree, two
    Trainer steps with and without compression, and a 4-step run
    checkpointed at step 2."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    arch = "prosparse-llama2-7b"
    tcfg = t_reduced(arch)
    w0 = _trainer_reference(arch, False, 2)[0]
    dkw = dict(vocab=tcfg.vocab, seq_len=S, global_batch=B)
    suite = {
        "grads": (list(MESHES.values()), _grad_cases()),
        "codes": (tcfg, _codes_input(tcfg)),
        "train": [(tcfg, w0, dkw, OPT, dict(steps=2, ckpt_every=100,
                                            ckpt_dir=str(tmp / f"c{c}"),
                                            grad_compression=c))
                  for c in (False, True)] + [
            (tcfg, w0, dkw, OPT, dict(steps=4, ckpt_every=2,
                                      ckpt_dir=str(tmp / "ck")))]}
    outs = run_ranks(MR.train_suite, (2, 2), ("data", "model"),
                     args=(suite,), timeout=300)
    return outs, tmp, tcfg, dkw


@functools.lru_cache(maxsize=None)
def _codes_input(tcfg):
    """A whole gradient tree (numpy, the port's layout) with leaves of
    four decades of scale."""
    return _fill(tlm.init_lm(tcfg, 0, "cpu"), np.random.default_rng(3))


def _fill(tree, rng):
    if isinstance(tree, dict):
        return {k: _fill(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, rng) for v in tree]
    scale = 10.0 ** rng.integers(-4, 0)
    return (rng.standard_normal(tuple(tree.shape)) * scale).astype(
        np.float32)


@pytest.mark.parametrize("mesh_id", ["2x2", "4x1", "1x4"])
def test_grads_match_reference(mesh_2x2, mesh_id):
    _check_suite_grads(mesh_2x2[0], mesh_id)


def test_compress_codes_on_2x2(mesh_2x2):
    """Codes and scales of a gradient tree placed on the ranks equal one
    process's bit for bit (the scale the max over the leaf's parts)."""
    import torch
    outs, _, tcfg, _ = mesh_2x2
    whole = _codes_input(tcfg)
    tw = tree_map(torch.from_numpy, whole)
    q, _ = GC.compress_grads(tw, GC.init_ef(tw))
    flat_q = [v for _, v in flatten(q)]
    got_codes, got_scales = outs[0]["codes"]
    for (path, c), (want_c, want_s), s in zip(
            flatten(got_codes), flat_q, got_scales):
        assert torch.equal(c, want_c), path
        assert s == float(want_s), path


@pytest.mark.parametrize("compress", [False, True])
def test_trainer_on_2x2_matches_reference(mesh_2x2, compress):
    """Two Trainer steps on 2x2 against the JAX Trainer run inside a 2x2
    host-device mesh on the same weights and batches: losses within 1e-5,
    grad norms within 1e-4 relative, every rank's history bitwise rank
    0's; params as test_torch_trainer holds the one-process port's."""
    outs = mesh_2x2[0]
    tcfg = mesh_2x2[2]
    _, jh, jp = _trainer_reference("prosparse-llama2-7b", compress, 2)
    hist, params = outs[0]["train"][int(compress)]
    assert all(o["train"][int(compress)][0] == hist for o in outs)
    for t, j in zip(hist, jh):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=1e-4)
    got = bridge.params_to_numpy(params, tcfg)
    from repro_torch.optim.adamw import cosine_lr
    bound = 2 * sum(float(cosine_lr(AdamWConfig(**OPT), s))
                    for s in (1, 2)) + 1e-6
    gaps = [np.abs(g - w) for g, w in zip(jax.tree.leaves(got),
                                          jax.tree.leaves(jp))]
    assert max(float(d.max()) for d in gaps) <= bound
    assert sum(int((d > 1e-6).sum()) for d in gaps) <= \
        sum(d.size for d in gaps) // 100


def test_checkpoint_resumes_on_1x2_and_one_process(mesh_2x2, tmp_path):
    """The 2x2 checkpoint of step 2 restores bitwise on 1x2 and on one
    process, and their steps 3-4 are within 1e-5 of the uninterrupted
    2x2 run's."""
    outs, tmp, tcfg, dkw = mesh_2x2
    full = {h["step"]: h["loss"] for h in outs[0]["train"][2][0]}
    import shutil
    for where in ("1x2", "one"):
        d = tmp_path / where
        shutil.copytree(tmp / "ck", d)
        for s in os.listdir(d):
            if s != "step_00000002":
                shutil.rmtree(d / s)
        tkw = dict(steps=2, ckpt_every=100, ckpt_dir=str(d))
        if where == "1x2":
            res = run_ranks(MR.train_suite, (1, 2), ("data", "model"),
                            args=({"resume": (tcfg, dkw, OPT, tkw, 2)},),
                            timeout=300)
            assert all(r["resume"] == res[0]["resume"] for r in res)
            res = res[0]["resume"]
        else:
            t = ttrainer.Trainer(tlm, tcfg, ttrainer.TrainerConfig(**tkw),
                                 AdamWConfig(**OPT), DataConfig(**dkw),
                                 device="cpu")
            t.init_state(seed=0)
            assert t.maybe_resume()
            with np.load(d / "step_00000002" / "shard_0.npz") as data:
                state = {"params": t.params, "mu": t.opt_state.mu,
                         "nu": t.opt_state.nu}
                same = all(np.array_equal(data[str(i)], v.detach().numpy())
                           for i, (_, v) in enumerate(flatten(state)))
            res = {"bitwise": same, "at": t.global_step,
                   "history": [{"step": h["step"], "loss": h["loss"]}
                               for h in t.run(2)]}
        assert res["bitwise"] and res["at"] == 2, where
        for h in res["history"]:
            np.testing.assert_allclose(h["loss"], full[h["step"]], rtol=0,
                                       atol=LOSS_TOL, err_msg=where)


def test_pod_data_model_mesh_equals_2x2(mesh_2x2):
    """2x1x2 (pod, data, model): its two (pod, data) lines are 2x2's two
    data lines, so every case is bitwise 2x2's; and held to the JAX
    package."""
    import torch
    got = _check_suite_grads(mesh_2x2[0], "2x1x2")
    want = mesh_2x2[0][0]["grads"]["2x2"]
    for (gl, gt), (wl, wt) in zip(got, want):
        assert gl == wl
        for (p, a), (_, b) in zip(flatten(gt), flatten(wt)):
            assert torch.equal(a, b), p


# ------------------------------------------------------------------ CLI --

def test_train_cli_on_a_2x2_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "prosparse-llama2-7b", "--reduced", "--device", "cpu", "--mesh",
         "2x2", "--steps", "2", "--global-batch", "4", "--seq", "16",
         "--ckpt-dir", str(tmp_path)], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "backend gloo" in out.stdout
    hist = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert [h["step"] for h in hist][:2] == [1, 2]
    assert np.isfinite([h["loss"] for h in hist]).all()
    assert os.path.isdir(tmp_path / "step_00000002")


def test_non_dense_family_raises_under_a_mesh(tmp_path):
    """``Trainer(mesh=)`` refuses another family, naming it (the CLI's
    refusal: ``test_torch_trainer.py::test_train_cli_refuses_a_mesh``)."""
    with pytest.raises(NotImplementedError, match="'moe'"):
        ttrainer.Trainer(tlm, t_reduced("olmoe-1b-7b"),
                         ttrainer.TrainerConfig(ckpt_dir=str(tmp_path)),
                         AdamWConfig(), DataConfig(vocab=512, seq_len=8,
                                                   global_batch=2),
                         device="cpu",
                         mesh=RankMesh(("data", "model"), (2, 2), 0))
