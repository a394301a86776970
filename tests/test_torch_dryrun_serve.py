"""``python -m repro_torch.launch.dryrun --all`` on ``meta`` and the
roofline over its records, for the serving shapes (prefill_32k,
decode_32k, long_500k); ``test_torch_dryrun_train_*.py`` sweep train_4k.

- every assigned (arch x shape) cell of the reference's list (every arch
  but ``prosparse*``) is ``ok``, or ``skipped`` with the reference's
  reason; ``--arch`` reaches any arch; a failing cell exits 1; a written
  cell is not run again without ``--force``;
- each record's bytes add up (state = params + caches + inputs (+ the
  optimizer's); total = state + the step's transient peak), ``fits``
  compares the total with the card's memory, and the largest batch that
  fits is 0 or fits on the record's own line;
- the roofline's model FLOPs are the reference's (6·N·D or 2·N·D, the
  active params for MoE), its terms the card's constants, and its table
  has a row for every record.
"""
import json
import os

import pytest

from repro.configs import base as JB
from repro.configs.registry import arch_names as j_archs
from repro.configs.registry import get_config as j_get
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import arch_names
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import HBM_BW, HBM_PER_CARD, PEAK_FLOPS_BF16

ASSIGNED = [a for a in j_archs() if not a.startswith("prosparse")]


def check_record(rec: dict) -> None:
    """One cell's record: its status, and its bytes and fit consistent."""
    assert rec["device"] == "h100x1"
    ok, reason = JB.shape_applicable(j_get(rec["arch"]),
                                     JB.SHAPES[rec["shape"]])
    if not ok:
        assert rec["status"] == "skipped" and rec["reason"] == reason
        return
    assert rec["status"] == "ok", rec.get("error")
    b = rec["bytes"]
    parts = ("params", "inputs") + (
        ("opt_state",) if rec["kind"] == "train" else
        ("caches",) if rec["kind"] == "decode" else ())
    assert set(b) == set(parts) | {"state", "transient_peak", "total"}
    assert b["state"] == sum(b[p] for p in parts)
    assert b["total"] == b["state"] + b["transient_peak"]
    assert rec["fits"] == (b["total"] <= HBM_PER_CARD)
    assert rec["fits_state"] == (b["state"] <= HBM_PER_CARD)
    if rec["fits"]:
        assert rec["max_batch"] >= rec["global_batch"]
    else:
        assert rec["max_batch"] < rec["global_batch"]
    cost = rec["step_cost"]
    assert cost["dot_flops"] > 0 and cost["bytes"] > 0
    assert cost["flops"] == cost["dot_flops"] + cost["ew_flops"]
    assert cost["dot_flops"] == sum(cost["flops_by_op"].values())


def sweep(tmp_path, shape: str, archs=None) -> list:
    """Run the CLI for ``shape`` over ``archs`` (None: ``--all``) and
    check every record it wrote."""
    out = str(tmp_path)
    runs = [["--all"]] if archs is None else [["--arch", a] for a in archs]
    for run in runs:
        assert D.main(run + ["--shape", shape, "--out", out]) == 0
    recs = []
    for arch in (ASSIGNED if archs is None else archs):
        with open(D.cell_path(arch, shape, out)) as f:
            recs.append(json.load(f))
        check_record(recs[-1])
    return recs


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_all_serving_cells_ok_or_skipped(tmp_path, shape):
    recs = sweep(tmp_path, shape)
    assert {r["arch"] for r in recs} == set(ASSIGNED)
    rows = R.full_table(str(tmp_path))
    assert len(rows) == len(recs)
    for row in rows:
        if "skipped" in row:
            continue
        assert "failed" not in row
        rec = next(r for r in recs if r["arch"] == row["arch"])
        cfg = j_get(row["arch"])
        n = cfg.active_param_count()
        s = SHAPES[shape]
        tokens = s.global_batch * (s.seq_len if s.kind == "prefill" else 1)
        assert row["model_flops"] == 2.0 * n * tokens
        assert row["compute_s"] == pytest.approx(
            rec["step_cost"]["flops"] / PEAK_FLOPS_BF16, rel=1e-5)
        assert row["memory_s"] == pytest.approx(
            rec["step_cost"]["bytes"] / HBM_BW, rel=1e-5)
        assert row["dominant"] in ("compute", "memory") and row["next"]
    table = R.markdown_table(rows)
    assert len(table.splitlines()) == 2 + len(rows)


def test_cli_cells_arch_reach_and_failures(tmp_path, monkeypatch):
    seen = []

    def fake(arch, shape):
        seen.append((arch, shape))
        if arch == "gemma2-2b" and shape == "decode_32k":
            raise RuntimeError("boom")
        return {"arch": arch, "shape": shape, "device": "h100x1",
                "status": "skipped", "reason": "test"}
    monkeypatch.setattr(D, "run_cell", fake)
    out = str(tmp_path)
    assert D.main(["--all", "--out", out]) == 1
    assert seen == [(a, s) for a in ASSIGNED for s in SHAPES]
    with open(D.cell_path("gemma2-2b", "decode_32k", out)) as f:
        failed = json.load(f)
    assert failed["status"] == "failed" and "boom" in failed["error"]
    seen.clear()
    assert D.main(["--all", "--out", out]) == 0       # every cell written
    assert seen == []
    assert D.main(["--arch", "prosparse-llama2-7b", "--shape", "decode_32k",
                   "--out", out]) == 0
    assert seen == [("prosparse-llama2-7b", "decode_32k")]
    assert arch_names() == j_archs()


def test_main_path_arch_prefill_32k(tmp_path):
    """The main path's arch (not in the assigned list), as phase 21 of
    chip_smoke.py runs it: prefill_32k at batch 1 fits the card."""
    rec = sweep(tmp_path, "prefill_32k", ["prosparse-llama2-7b"])[0]
    assert rec["max_batch"] >= 1
    assert os.path.exists(D.cell_path("prosparse-llama2-7b", "prefill_32k",
                                      str(tmp_path)))
