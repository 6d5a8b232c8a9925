"""Cells, configurations, traffic mixes and metric readers are found by
name, and ``BENCHMARK.json`` keeps to the benchmark's contract."""

from __future__ import annotations

import json
import pathlib
import re
import shutil

import pytest

from bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.load_cell(cell, ROOT)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["name"] == c.entry["traffic"]
    assert c.per_layer and any(m["name"] == "reads_per_s"
                               for m in c.end_to_end)
    assert c.chunk_items * c.read_len * (2 if c.paired else 1) \
        >= c.chunk_bases


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric, ROOT))


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and 1 <= SPEC["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in SPEC["end_to_end"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["name"] in {w["config"] for w in SPEC["workloads"]}
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_new_cell_and_metric_are_picked_up(tmp_path):
    """A cell, configuration, traffic mix and metric added as new files
    and entries, with no existing file edited."""
    root = tmp_path
    shutil.copytree(ROOT / "bench" / "configs", root / "bench" / "configs")
    shutil.copytree(ROOT / "bench" / "traffic", root / "bench" / "traffic")
    shutil.copytree(ROOT / "bench" / "metrics", root / "bench" / "metrics")
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((ROOT / "bench/configs/ecoli_k12-se101.json")
                     .read_text())
    cfg.update(name="ecoli_k12-se151", reads={"layout": "se", "length": 151})
    (root / "bench/configs/ecoli_k12-se151.json").write_text(json.dumps(cfg))
    mix = dict(json.loads((ROOT / "bench/traffic/wgsim.json").read_text()),
               name="noisy", error_rate=0.05)
    (root / "bench/traffic/noisy.json").write_text(json.dumps(mix))
    (root / "bench/metrics/chunks_per_s.py").write_text(
        "def read(ctx):\n    return ctx.n_chunks / ctx.window_s\n")
    spec["configs"].append(dict(spec["configs"][0], name="ecoli_k12-se151",
                                file="bench/configs/ecoli_k12-se151.json"))
    spec["workloads"].append({"name": "ecoli_k12-se151.noisy",
                              "config": "ecoli_k12-se151",
                              "traffic": "noisy", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "chunks_per_s", "unit": "chunks/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "api and io", "moves": "reads_per_s",
                              "workloads": ["ecoli_k12-se151.noisy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("ecoli_k12-se151.noisy", root)
    assert cell.read_len == 151 and cell.traffic["error_rate"] == 0.05
    assert "chunks_per_s" in [m["name"] for m in cell.per_layer]
    read = harness.reader("chunks_per_s", root)
    ctx = harness.Context(cell, 100, 4, 2.0, {}, {}, {}, {})
    assert read(ctx) == 2.0
    # the new metric is the new cell's only: an old cell does not get it
    old = harness.load_cell("ecoli_k12-se101.wgsim", root)
    assert "chunks_per_s" not in [m["name"] for m in old.per_layer]


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no-such.cell", ROOT)
