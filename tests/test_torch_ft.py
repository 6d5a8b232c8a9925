"""The port's fault-tolerance layer (``repro_torch.ft``) against the
reference (``repro.ft``).

* ``CheckpointManager``: round trip, keep-last-k garbage collection, a
  corrupt newest step falling back to an older one, and an in-flight
  ``.tmp`` never visible;
* checkpoints restore across packages in both directions — the memdist
  shard state and a nested dict/list/tuple/None state — with equal
  ``MANIFEST.json`` leaves (keys, files, dtypes, shapes, checksums);
* ``plan_shards``, ``plan_remesh`` and ``StragglerMonitor`` return what
  the reference returns over a grid of inputs.
"""

import json
import shutil

import numpy as np
import pytest

from repro import ft as rft
from repro_torch import ft as tft


def _state(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(8, 8)).astype(np.float32),
                       "b": rng.normal(size=(8,)).astype(np.float32)},
            "opt": {"mu": {"w": np.zeros((8, 8), np.float32),
                           "b": np.zeros((8,), np.float32)},
                    "step": np.int32(seed)}}


def _nested(seed):
    """dict keys out of sorted order, lists, tuples, None subtrees and
    scalar leaves of several dtypes."""
    rng = np.random.default_rng(seed)
    return {"zeta": [np.int64(seed), None,
                     (rng.integers(0, 9, 5).astype(np.int16),
                      {"b": np.float64(seed / 3), "a": None})],
            "alpha": {"y": rng.normal(size=(2, 3)).astype(np.float32),
                      "x": [], "w": (np.uint8(seed),)},
            "mid": None}


def _memdist(seed):
    """The shape of ``dist.run``'s per-shard checkpoint."""
    return {"chunks_done": np.int64(seed), "sam_offset": np.int64(97 * seed),
            "n_reads": np.int64(3 * seed), "n_records": np.int64(4 * seed)}


STATES = {"memdist": _memdist, "nested": _nested, "train": _state}


def assert_tree_equal(got, want):
    assert type(got) is type(want) or (
        isinstance(want, np.generic) and isinstance(got, np.ndarray))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_equal(g, w)
    elif want is None:
        assert got is None
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    mgr = tft.CheckpointManager(tmp_path, keep=2)
    for i in (1, 2, 3, 4):
        mgr.save(i, _state(i))
    assert mgr.steps() == [3, 4]                  # _gc kept the last 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000004"]
    got, step = mgr.restore(_state(0))
    assert step == 4
    assert_tree_equal(got, _state(4))
    got, step = mgr.restore(_state(0), step=3)
    assert step == 3
    assert_tree_equal(got, _state(3))


def test_checkpoint_corruption_falls_back(tmp_path, capsys):
    mgr = tft.CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    victim = next((mgr.dir / "step_00000002").glob("*.npy"))
    np.save(victim, np.load(victim) + 1)
    got, step = mgr.restore(_state(0))
    assert step == 1
    assert_tree_equal(got, _state(1))
    assert "checksum mismatch" in capsys.readouterr().out
    # nothing usable at all: the restart path says so
    victim = next((mgr.dir / "step_00000001").glob("*.npy"))
    np.save(victim, np.load(victim) + 1)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(0))


def test_checkpoint_tmp_and_incomplete_dirs_invisible(tmp_path):
    mgr = tft.CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    shutil.copytree(mgr.dir / "step_00000001", mgr.dir / "step_00000003.tmp")
    (mgr.dir / "step_00000002" / "MANIFEST.json").unlink()
    assert mgr.steps() == [1]
    got, step = mgr.restore(_state(0))
    assert step == 1
    assert_tree_equal(got, _state(1))


def test_checkpoint_missing_leaf_refused(tmp_path):
    mgr = tft.CheckpointManager(tmp_path)
    mgr.save(1, {"a": np.int64(1)})
    with pytest.raises(FileNotFoundError):
        mgr.restore({"a": np.int64(0), "b": np.int64(0)})


@pytest.mark.parametrize("kind", sorted(STATES))
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(tmp_path, kind, writer):
    """One state saved by each package: the MANIFEST.json files agree
    leaf for leaf, and the state written by ``writer`` restores in the
    other package into ``like_state``'s structure, bytes equal."""
    make = STATES[kind]
    manifests = {}
    for pkg, ft in (("reference", rft), ("port", tft)):
        ft.CheckpointManager(tmp_path / pkg).save(7, make(5))
        manifests[pkg] = json.loads(
            (tmp_path / pkg / "step_00000007" / "MANIFEST.json").read_text())
    assert manifests["port"] == manifests["reference"]
    assert list(manifests["port"]["leaves"]) == list(
        manifests["reference"]["leaves"])
    reader = tft if writer == "reference" else rft
    got, step = reader.CheckpointManager(tmp_path / writer).restore(make(0))
    assert step == 7
    assert_tree_equal(got, make(5))


@pytest.mark.parametrize("workers", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4, 7, 16])
def test_plan_shards_equals_reference(workers, n_chunks):
    got = tft.plan_shards(0, workers, 1000, n_chunks=n_chunks)
    want = rft.plan_shards(0, workers, 1000, n_chunks=n_chunks)
    assert [(p.shard, p.start, p.stop) for p in got] == [
        (p.shard, p.start, p.stop) for p in want]
    assert sum(p.n_chunks for p in got) == n_chunks
    for hint, cb in ((0, 100), (59, 1000), (1000, 9696)):
        assert tft.plan_shards(hint, workers, cb) == [
            tft.ShardPlan(p.shard, p.start, p.stop)
            for p in rft.plan_shards(hint, workers, cb)]
    for bad in ((0, 0, 10), (0, 1, 0), (-1, 1, 10)):
        for ft in (tft, rft):
            with pytest.raises(ValueError):
                ft.plan_shards(*bad)


@pytest.mark.parametrize("chips", [16, 17, 31, 64, 250, 256, 4096, 5000])
@pytest.mark.parametrize("model", [1, 8, 16])
def test_plan_remesh_equals_reference(chips, model):
    for keep in (True, False):
        kw = dict(model=model, target_global_batch=256,
                  per_replica_batch=2, keep_global_batch=keep)
        got = tft.plan_remesh(chips, **kw)
        want = rft.plan_remesh(chips, **kw)
        assert (got.data, got.model, got.pods, got.grad_accum,
                got.dropped_chips, got.n_chips) == (
            want.data, want.model, want.pods, want.grad_accum,
            want.dropped_chips, want.n_chips)
    with pytest.raises(ValueError):
        tft.plan_remesh(model - 1, model=model)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window,threshold,persist,min_samples", [
    (32, 1.8, 3, None), (8, 1.5, 2, 2), (16, 1.2, 1, 4)])
def test_straggler_monitor_equals_reference(seed, window, threshold,
                                            persist, min_samples):
    """Both monitors see the same step times (heavy-tailed, several
    hosts) and judge every one the same way."""
    rng = np.random.default_rng(seed)
    times = rng.lognormal(mean=-3.0, sigma=0.6, size=80)
    hosts = rng.integers(0, 4, size=80)
    mons = [ft.StragglerMonitor(window=window, threshold=threshold,
                                persist=persist, min_samples=min_samples)
            for ft in (tft, rft)]
    n_events = 0
    for step, (t, h) in enumerate(zip(times, hosts)):
        evs = [m.observe(step, host=int(h), step_time=float(t))
               for m in mons]
        if evs[1] is None:
            assert evs[0] is None
            continue
        n_events += 1
        assert (evs[0].step, evs[0].host, evs[0].step_time, evs[0].median,
                evs[0].action) == (evs[1].step, evs[1].host,
                                   evs[1].step_time, evs[1].median,
                                   evs[1].action)
        assert mons[0].rebalance_fraction(int(h)) == \
            mons[1].rebalance_fraction(int(h))
    assert n_events > 0
    assert mons[0].min_samples == mons[1].min_samples
