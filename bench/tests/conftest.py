"""Fixtures of the benchmark's tests: a checkout in a temporary directory
that holds tiny cells (a 55-kbp genome) beside the real ``bench/``
modules, so the harness runs end to end on the CPU in seconds.

Run them from the root of the repo: ``python -m pytest bench/tests``.
Tests marked ``card`` need a CUDA device and skip without one."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
# the port, as the harness finds it in a checkout
sys.path.insert(0, str(ROOT / "src"))
MODULES = ("__init__.py", "frozen", "reference", "producer.py",
           "harness.py", "trace.py", "run.py", "metrics", "control.py")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card only")
    return torch.device("cuda")


def tiny_checkout(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout at ``tmp``: ``src`` and the bench modules linked, the
    real traffic mixes copied, tiny configurations and cells."""
    (tmp / "src").symlink_to(ROOT / "src")
    (tmp / "bench").mkdir()
    for name in MODULES:
        (tmp / "bench" / name).symlink_to(BENCH / name)
    shutil.copytree(BENCH / "traffic", tmp / "bench" / "traffic")
    (tmp / "bench" / "configs").mkdir()
    base = json.loads((BENCH / "configs" / "sc_r64-pe151.json").read_text())
    for name, contigs, layout, length, items in (
            ("tiny-se", [["c1", 30000], ["c2", 20000]], "se", 101, 200),
            ("tiny-pe", [["c1", 30000], ["c2", 20000], ["cM", 5000]],
             "pe", 151, 100)):
        cfg = dict(base, name=name,
                   genome=dict(base["genome"], seed=len(name) + items,
                               contigs=contigs),
                   reads={"layout": layout, "length": length},
                   chunk_bases=items * length * (2 if layout == "pe" else 1))
        (tmp / "bench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [
        {"name": "tiny-se.wgsim", "config": "tiny-se", "traffic": "wgsim",
         "chips": 1, "why": "tiny SE cell of the tests"},
        {"name": "tiny-pe.wgsim", "config": "tiny-pe",
         "traffic": "wgsim", "chips": 1,
         "why": "tiny PE cell of the tests"}]
    for m in spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-pe.wgsim"]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


@pytest.fixture(scope="session")
def checkout(tmp_path_factory) -> pathlib.Path:
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))
