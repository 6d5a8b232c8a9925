"""The result line's shape, the import check by whole top-level names,
and the exits without a card or without the port."""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name,bad", [
    ("repro", True), ("repro.core.smem", True), ("jax", True),
    ("jaxlib.xla_client", True), ("flax.linen", True),
    ("repro_torch", False), ("repro_torch.api", False), ("reprox", False),
    ("jax_helpers", False), ("bench.reference", False)])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in harness.forbidden_modules()) is bad


def test_reference_imports_nothing_of_the_port():
    """Every import of the reference and of the frozen yardstick is of
    the standard library, numpy, torch or themselves."""
    import ast
    allowed = {"numpy", "torch", "__future__"} | set(sys.stdlib_module_names)
    for sub in ("reference", "frozen"):
        for path in (ROOT / "bench" / sub).rglob("*.py"):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    names = [node.module]
                else:
                    continue
                for n in names:
                    assert n.split(".")[0] in allowed, (path, n)


def _run(args, cwd):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_exits_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["--workload", "ecoli_k12-se101.wgsim", "--seed", "1",
              "--seconds", "1", "--trace", "0"], ROOT)
    assert r.returncode == 2 and r.stdout == ""


def test_exits_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(["--workload", "ecoli_k12-se101.wgsim", "--seed", "1",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_result_line_shape(checkout):
    out = harness.run_cell("tiny-se.wgsim", 2 ** 31 + 7, 1.0, False,
                           device="cpu", root=checkout)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 200 and out["attempted"] % 200 == 0
    assert set(out["metrics"]) == {"reads_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all({"value", "limit"} <= set(c) for c in out["checks"].values())
    # set-up's parts, the checkout's builds among them, lie inside setup_s
    parts = out["setup_parts"]
    assert set(parts) == {"import_s", "build_s", "index_load_s",
                          "warm_up_s", "reads_s"}
    assert sum(parts.values()) <= out["metrics"]["setup_s"]["value"]
    json.dumps(out)


def test_traced_result_has_the_per_layer_metrics(checkout):
    out = harness.run_cell("tiny-pe.wgsim", 99, 1.0, True,
                           device="cpu", root=checkout)
    assert out["correct"] is True
    got = set(out["metrics"])
    # the CPU has no device trace: no roofline, no idle share
    assert {"smem_ms_per_kread", "bsw_ms_per_kread", "pe_ms_per_kread",
            "index_load_s", "smem_rounds_per_chunk"} <= got
    assert not any(k.endswith("_roofline") for k in got)
    assert "device_idle_pct" not in got


def test_no_process_is_left(checkout):
    before = _children()
    harness.run_cell("tiny-se.wgsim", 5, 0.5, False, device="cpu",
                     root=checkout)
    assert _children() == before


def _children() -> set:
    import os
    me = str(os.getpid())
    out = set()
    for p in pathlib.Path("/proc").iterdir():
        if p.name.isdigit():
            try:
                stat = (p / "stat").read_text().split()
            except OSError:
                continue
            if stat[3] == me:
                out.add(p.name)
    return out
