"""The port stands alone: importing every ``repro_torch`` module (and
``chip_smoke.py``) loads neither JAX nor the reference package; and its
entry points never fall back to the CPU on their own."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              'repro_torch.')]
for m in mods:
    importlib.import_module(m)
sys.path.insert(0, {repo!r})
import chip_smoke
leaked = sorted(k for k in sys.modules
                if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))
print(len(mods), leaked)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE.format(repo=REPO)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20, out.stdout
    assert leaked == "[]", out.stdout


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")


def test_server_without_device_raises_without_gpu():
    _no_gpu()
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models import lm
    from repro_torch.runtime.server import Server, ServeConfig
    cfg = reduced_config("prosparse-llama2-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(lm, cfg, ServeConfig(), lm.init_lm(cfg, 0, device="cpu"))


@pytest.mark.parametrize("entry", ["init_lm", "init_caches",
                                   "init_kv_pool", "params_from_numpy"])
def test_entry_points_default_to_the_card(entry):
    """Without a GPU these raise unless asked for ``device="cpu"``, and
    then put their tensors on the CPU."""
    _no_gpu()
    import numpy as np
    from repro_torch import bridge
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models import lm
    cfg = reduced_config("prosparse-llama2-7b")
    if entry == "params_from_numpy":
        params = lm.init_lm(cfg, 0, device="cpu")

        def numpy_tree(nodes):          # the reference's layer-stacked tree
            if isinstance(nodes[0], dict):
                return {k: numpy_tree([n[k] for n in nodes])
                        for k in nodes[0]}
            return np.stack([n.numpy() for n in nodes])
        tree = {k: {kk: vv.numpy() for kk, vv in v.items()}
                for k, v in params.items() if k != "blocks"}
        tree["blocks"] = numpy_tree(params["blocks"])

        def call(**kw):
            return bridge.params_from_numpy(tree, cfg, **kw)
    elif entry == "init_lm":
        def call(**kw):
            return lm.init_lm(cfg, 0, **kw)
    elif entry == "init_kv_pool":
        def call(**kw):
            return lm.init_kv_pool(cfg, 6, 4, **kw)
    else:
        def call(**kw):
            return lm.init_caches(cfg, 2, 8, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    leaves, stack = [], [call(device="cpu")]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
        elif torch.is_tensor(node):
            leaves.append(node)
    assert leaves and all(t.device.type == "cpu" for t in leaves)


def test_serve_cli_without_device_raises_without_gpu():
    _no_gpu()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "prosparse-llama2-7b", "--reduced"])


def test_serve_cli_on_cpu_reports(capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--arch", "prosparse-llama2-7b", "--reduced",
                      "--device", "cpu", "--strategy", "pallas",
                      "--requests", "3", "--batch", "2", "--max-new", "3",
                      "--sla-mix", "latency:1,balanced:1,quality:1"])
    assert rep["completed"] == 3 and rep["tokens"] == 9
    assert rep["sla_mix"] == {"latency": 1, "balanced": 1, "quality": 1}
    assert '"tok_per_s"' in capsys.readouterr().out
