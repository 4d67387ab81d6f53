"""The port's examples (``examples/*_torch.py``) against the reference's.

Each twin runs in-process with ``--device cpu`` at a small size and must
print its reference example's labelled lines in the same order.  The
reference's lines come from its own run under JAX's CPU backend
(``examples/{quickstart,decompose_frostt,serve_lm}.py``, ~10 s each
here).  ``examples/train_lm.py`` cannot run under jax 0.9 (the
reference's mesh path, ROADMAP C11), so the train twin is held to the
labels of the reference launcher's ``print`` calls.  The CP twins' fits
also keep the CP invariants: log-likelihood nondecreasing, factors
nonnegative, every column summing to 1.
"""
import ast
import functools
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.core import policy as P_policy
from repro_torch.data.tensors import make_tensor
from repro_torch.testing.dist import example_checks, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
TWINS = ("quickstart", "decompose_frostt", "serve_lm", "train_lm")
SERVE_ARGV = ["--batch", "4", "--new-tokens", "4"]
REF_TIMEOUT = 300  # seconds for one reference example (~10 s alone)
SPAWN_TIMEOUT = 300
# a sweep may lower the printed (rounded) log-likelihood by no more than
# f32 rounding of its sum
LL_SLACK = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, so the solves do not contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def twin_path(name: str) -> str:
    return os.path.join(EXAMPLES, f"{name}_torch.py")


def run_twin(name: str, argv, record: list | None = None) -> list:
    """The lines the twin prints, run in this process on ``argv``."""
    rc, lines = example_checks(0, 1, twin_path(name), argv, record)
    assert rc == 0
    return lines


def label(line: str) -> str:
    """A printed line's label: its text before the first ':', '=' or digit,
    without trailing blanks."""
    return re.match(r"[^:=\d]*", line).group(0).rstrip()


def labels(lines) -> list:
    """The labels of ``lines``, runs of one label (a loop's lines) kept once."""
    out = []
    for ln in lines:
        if not out or out[-1] != label(ln):
            out.append(label(ln))
    return out


@functools.lru_cache(maxsize=None)
def reference_lines(name: str, argv: tuple = ()) -> list:
    """The lines the reference example prints under JAX's CPU backend."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, f"{name}.py"), *argv],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=REF_TIMEOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def check_cp_invariants(res) -> None:
    ll = res.loglik_history
    assert len(ll) == res.n_outer and all(math.isfinite(x) for x in ll)
    assert all(b >= a - LL_SLACK * abs(a) for a, b in zip(ll, ll[1:])), ll
    for f in res.ktensor.factors:
        assert bool(torch.isfinite(f).all()) and bool((f >= 0).all())
        torch.testing.assert_close(f.sum(dim=0), torch.ones(f.shape[1]),
                                   rtol=0, atol=1e-5)


def float_list(line: str) -> list:
    return [float(x) for x in ast.literal_eval(line.split(":", 1)[1])]


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_the_reference(name):
    with open(twin_path(name)) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    roots = {m.split(".")[0] for m in mods}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


@pytest.mark.parametrize("name", TWINS)
def test_twin_defaults_to_the_card_and_raises_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"serve_lm": SERVE_ARGV, "train_lm": ["--steps", "1"]}.get(name,
                                                                    [])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_twin(name, argv)


def test_quickstart_twin():
    results = []
    lines = run_twin("quickstart", ["--device", "cpu"], results)
    assert "Phi strategy: segment" in lines
    twin = [ln for ln in lines if not ln.startswith("Phi strategy:")]
    assert labels(twin) == labels(reference_lines("quickstart"))
    assert len(twin) == len(reference_lines("quickstart"))
    (res,) = results
    check_cp_invariants(res)
    assert res.n_outer == 10
    assert [f"{x:.0f}" for x in res.loglik_history] == [
        str(x) for x in ast.literal_eval(lines[3].split(":", 1)[1])]


def test_decompose_frostt_twin(monkeypatch):
    """``--device cpu`` takes the CPU's policy even where a card is
    available: the heuristic is asked for the platform the tensor lives
    on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    results = []
    lines = run_twin("decompose_frostt", ["--device", "cpu"], results)
    assert labels(lines) == labels(reference_lines("decompose_frostt"))
    (res,) = results
    check_cp_invariants(res)
    t, _ = make_tensor("uber", scale=0.003, rank=8, device="cpu")
    want = P_policy.heuristic_policy(t.nnz, t.shape[0], 8, platform="cpu")
    assert lines[1] == f"heuristic policy for this platform: {want.label()}"
    assert want.strategy == "segment"
    assert float_list(lines[2]) == pytest.approx(res.kkt_history, abs=5e-5)


def test_decompose_frostt_twin_distributed_on_two_ranks(tmp_path):
    res = run_ranks(2, "example_checks",
                    (twin_path("decompose_frostt"),
                     ["--device", "cpu", "--distributed"]),
                    str(tmp_path / "work"), timeout=SPAWN_TIMEOUT)
    (rc0, lines), (rc1, quiet) = res
    assert rc0 == rc1 == 0
    assert quiet == []  # only rank 0 prints
    assert [label(ln) for ln in lines] == [
        "uber", "heuristic policy for this platform",
        "distributed CP-APR on mesh {'data'", "KKT history"]
    assert lines[2] == ("distributed CP-APR on mesh "
                        "{'data': 1, 'model': 2}")
    kkt = float_list(lines[3])
    assert len(kkt) == 5 and all(math.isfinite(x) for x in kkt)


def test_serve_lm_twin():
    lines = run_twin("serve_lm", SERVE_ARGV + ["--device", "cpu"])
    ref = reference_lines("serve_lm", tuple(SERVE_ARGV))
    assert labels(lines) == labels(ref) == ["[serve] arch",
                                            "[serve] first sequence"]
    assert lines[0].startswith("[serve] arch=h2o-danube-1.8b-smoke ")
    assert "generated (4, 4) tokens" in lines[0]


def reference_print_labels(path: str) -> list:
    """The labels of the string literals that open the ``print`` calls of
    a source file, in source order."""
    with open(path) as f:
        tree = ast.parse(f.read())
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "print" and node.args):
            arg = node.args[0]
            head = arg.values[0] if isinstance(arg, ast.JoinedStr) else arg
            if isinstance(head, ast.Constant):
                found.append((node.lineno, label(head.value)))
    return [lab for _, lab in sorted(found)]


def test_train_lm_twin_trains_and_resumes(tmp_path):
    ref = reference_print_labels(
        os.path.join(ROOT, "src", "repro", "launch", "train.py"))
    assert ref == ["[train] arch", "[train] step", "[train] done at step"]
    argv = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    for steps, start in ((2, 0), (4, 2)):
        lines = run_twin("train_lm", argv + ["--steps", str(steps)])
        assert labels(lines) == ref
        assert lines[0].startswith("[train] arch=olmo-1b-smoke ")
        assert lines[0].endswith(f"start_step={start}")
        step_lines = [ln.split() for ln in lines
                      if ln.startswith("[train] step")]
        assert [int(s[2]) for s in step_lines] == list(
            range(start + 1, steps + 1))
        assert all(math.isfinite(float(s[4])) for s in step_lines)
        assert lines[-1].startswith(f"[train] done at step {steps}")
