"""The collector's metric, ``gc_ms_per_kread``, and the E. coli cell at
bwa's own batch width."""

from __future__ import annotations

import json
import pathlib

from bench import harness
from bench.frozen import genome as G

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_every_cell_reports_the_collector():
    for name in CELLS:
        cell = harness.load_cell(name, ROOT)
        assert "gc_ms_per_kread" in [m["name"] for m in cell.per_layer], name


def test_uncut_cell_maps_bwa_batch():
    cell = harness.load_cell("ecoli_k12-se101-k10m.wgsim", ROOT)
    assert cell.chunk_bases == 10_000_000
    assert cell.chunk_items == 99_010
    assert cell.config["reduced"] == {}


def test_uncut_cell_shares_the_bundle():
    wide = harness.load_cell("ecoli_k12-se101-k10m.wgsim", ROOT)
    narrow = harness.load_cell("ecoli_k12-se101.wgsim", ROOT)
    assert G.bundle_key(wide.config["genome"]) == \
        G.bundle_key(narrow.config["genome"])
    for key in ("reference", "reads", "options", "guarantees", "assumed"):
        assert wide.config[key] == narrow.config[key], key


def _ctx(stats: dict) -> harness.Context:
    cell = harness.load_cell(CELLS[0], ROOT)
    return harness.Context(cell, 2_000, 1, 1.0, stats, {}, {}, {})


def test_gc_metric_is_none_without_the_counter():
    read = harness.reader("gc_ms_per_kread", ROOT)
    assert read(_ctx({"time_smem_s": 1.0})) is None


def test_gc_metric_reads_the_counter():
    read = harness.reader("gc_ms_per_kread", ROOT)
    assert read(_ctx({"time_gc_s": 0.5})) == 250.0
    assert read(_ctx({"time_gc_s": 0.0})) == 0.0


def test_traced_run_reports_the_collector(checkout):
    out = harness.run_cell("tiny-se.wgsim", 2 ** 31 + 19, 0.5, True,
                           device="cpu", root=checkout)
    assert out["correct"] is True
    assert out["metrics"]["gc_ms_per_kread"]["value"] >= 0.0
    assert out["metrics"]["gc_ms_per_kread"]["unit"] == "ms/kread"
