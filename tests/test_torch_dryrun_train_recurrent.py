"""``python -m repro_torch.launch.dryrun`` at train_4k on ``meta`` for
the recurrent archs (zamba2-1.2b, xlstm-125m: their time loops run one
middle step for many, ``layers/scan_utils.py``), checked as
``test_torch_dryrun_train_dense.py`` checks its archs."""
import pytest

from test_torch_dryrun_train_dense import check_train


@pytest.mark.parametrize("archs", [("zamba2-1.2b",), ("xlstm-125m",)])
def test_train_cells_ok(tmp_path, archs):
    check_train(tmp_path, archs)
