"""A cell, configuration, traffic mix or per-layer metric is added by files
and entries alone: the harness finds each by its name, with no edit to a
file that is there."""
import json
import shutil

import torch

from portbench import harness

CPU = torch.device("cpu")


def _copy_benchmark(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path / "portbench"


def test_added_files_are_found_by_name(tmp_path):
    bench_dir = _copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "source": "made up for this test", "dims": [9, 8, 7],
        "nnz": 300, "generator": "planted_poisson", "planted_rank": 4,
        "assumed": {}, "reduced": []}))
    (bench_dir / "traffic" / "cpapr-short.json").write_text(json.dumps({
        "solver": "cpapr_mu", "rank": 4, "strategy": "cuda", "max_outer": 3,
        "max_inner": 5, "tol": 1e-4, "warmup_outer": 1}))
    (bench_dir / "cells" / "tiny.cpapr-short.json").write_text(json.dumps({
        "limits": {"lam_rel": 1e-3, "factor_rel": 1e-3}}))
    (bench_dir / "metrics" / "solves.count.py").write_text(
        "def read(run):\n    return len(run.solves)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "made up",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.cpapr-short", "config": "tiny",
                               "traffic": "cpapr-short", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "solves.count", "unit": "solves",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "sweep_s",
                               "workloads": ["tiny.cpapr-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("tiny.cpapr-short", root=tmp_path)
    assert cell.config["dims"] == [9, 8, 7]
    assert cell.traffic["max_outer"] == 3
    assert cell.limits == {"lam_rel": 1e-3, "factor_rel": 1e-3}
    assert [m["name"] for m in cell.per_layer][-1] == "solves.count"
    assert [m["name"] for m in cell.end_to_end] == ["sweep_s", "setup_s"]
    out = harness.execute(cell, 5, 0.2, True, CPU, 0.0)
    assert out["metrics"]["solves.count"] == {
        "value": float(out["attempted"]), "unit": "solves"}
    # the cells that were there see none of it, and no file changed
    old = harness.load_cell("uber.cpapr", root=tmp_path)
    assert "solves.count" not in [m["name"] for m in old.per_layer]
    for p, data in before.items():
        assert p.read_bytes() == data, p
