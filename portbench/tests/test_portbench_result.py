"""The result's last line, and the runs that must print none."""
import json
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import shrunk

from portbench import harness

CPU = torch.device("cpu")


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_shape(trace, capsys):
    cell = shrunk("uber.cpapr", 8, max_outer=3)
    out = harness.execute(cell, 2**31 + 99, 0.3, bool(trace), CPU, 0.0)
    line = json.dumps(out)
    r = json.loads(line)
    assert "\n" not in line
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(r["correct"], bool)
    assert r["attempted"] >= 1 and r["failed"] == 0
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    assert set(r["metrics"]) <= set(units)
    if not trace:
        assert set(r["metrics"]) == {"sweep_s", "setup_s"}
    else:  # no device here: the readers of the device trace find nothing
        assert set(r["metrics"]) == {"prep_s", "inner_iters"}
        assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, m in r["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert r["device"]["count"] == cell.chips
    assert set(r["checks"]) == {"lam_rel", "factor_rel"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "uber.cpapr", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "needs 1 CUDA device" in out.err


def test_foreign_module_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "execute",
                        lambda *a: {"checks": {}, "correct": True})
    monkeypatch.setitem(sys.modules, "jax", object())
    rc = harness.main(["--workload", "uber.cpapr", "--seed", "1",
                       "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "jax" in out.err


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the harness has no program
    to measure: the command fails and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "uber.cpapr",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
