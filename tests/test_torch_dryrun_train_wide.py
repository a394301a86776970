"""``python -m repro_torch.launch.dryrun`` at train_4k on ``meta`` for
qwen1.5-32b, qwen3-8b, llama-3.2-vision-90b and seamless-m4t-medium,
checked as ``test_torch_dryrun_train_dense.py`` checks its archs."""
import pytest

from test_torch_dryrun_train_dense import check_train


@pytest.mark.parametrize("archs", [("qwen1.5-32b", "qwen3-8b"),
                                   ("llama-3.2-vision-90b",
                                    "seamless-m4t-medium")])
def test_train_cells_ok(tmp_path, archs):
    check_train(tmp_path, archs)
