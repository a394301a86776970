"""``python -m repro_torch.launch.dryrun`` at train_4k on ``meta`` for
deepseek-moe-16b, gemma2-2b, granite-34b and olmoe-1b-7b (``--arch`` a
cell at a time; with ``test_torch_dryrun_train_wide.py``,
``test_torch_dryrun_train_recurrent.py`` and
``test_torch_dryrun_serve.py`` the whole ``--all`` sweep): every cell
``ok``, its record checked as in ``test_torch_dryrun_serve.py``, the
optimizer state twice the float32 params, and the roofline's model FLOPs
6·N·D."""
import pytest

from repro.configs.registry import get_config as j_get
from repro_torch.launch import roofline as R
from test_torch_dryrun_serve import sweep

ARCHS = ("deepseek-moe-16b", "gemma2-2b", "granite-34b", "olmoe-1b-7b")


def check_train(tmp_path, archs) -> None:
    recs = sweep(tmp_path, "train_4k", archs)
    rows = R.full_table(str(tmp_path))
    assert [r["arch"] for r in rows] == sorted(archs)
    for row in rows:
        n = j_get(row["arch"]).active_param_count()
        assert row["model_flops"] == 6.0 * n * 256 * 4096
    # AdamW's float32 moments: twice the float32 params' bytes
    for rec in recs:
        assert rec["bytes"]["opt_state"] == 2 * rec["bytes"]["params"]


@pytest.mark.parametrize("archs", [ARCHS[:2], ARCHS[2:]])
def test_train_cells_ok(tmp_path, archs):
    check_train(tmp_path, archs)
