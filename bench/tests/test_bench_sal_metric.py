"""``sal_device_ns_per_row``: the SAL gather's device seconds over the
rows it looked up, in ns a row, read from a hand-made ``Context``; no
value where the run has no such span or counter (an untraced run, or a
program that does not time the gather)."""

from __future__ import annotations

import json
import pathlib

import pytest

from bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def ctx_with(stats: dict) -> harness.Context:
    cell = harness.load_cell("grch38_chr1-pe151.wgsim", ROOT)
    return harness.Context(cell, 6624, 1, 2.0, stats, {}, {}, {})


def test_ns_per_row():
    read = harness.reader("sal_device_ns_per_row", ROOT)
    v = read(ctx_with({"time_device_sal_s": 0.0025, "sal_rows": 125_000,
                       "time_sal_s": 0.5}))
    assert v == pytest.approx(20.0)


@pytest.mark.parametrize("stats", [
    {}, {"sal_rows": 125_000}, {"time_device_sal_s": 0.0025},
    {"time_device_sal_s": 0.0025, "sal_rows": 0},
    {"time_device_sal_s": 0.0, "sal_rows": 125_000}],
    ids=["none", "no_span", "no_rows", "zero_rows", "zero_time"])
def test_none_without_both(stats):
    read = harness.reader("sal_device_ns_per_row", ROOT)
    assert read(ctx_with(stats)) is None


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_it(cell):
    """No ``workloads`` list: every cell runs the SAL gather."""
    c = harness.load_cell(cell, ROOT)
    assert "sal_device_ns_per_row" in [m["name"] for m in c.per_layer]
