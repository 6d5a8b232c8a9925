"""Fault-tolerant checkpointing: atomic, sharded-by-leaf, keep-last-k.

* every host writes only its addressable shards (here: single-host, all);
* writes go to ``step_<n>.tmp/`` then os.replace() to ``step_<n>/`` —
  a crash mid-write can never corrupt the latest durable checkpoint;
* a ``MANIFEST.json`` carries the leaf keys + dtypes + a content
  checksum per leaf, verified on restore;
* keep-last-k garbage collection;
* restore() returns (state, step) from the newest complete checkpoint,
  skipping incomplete/corrupt ones — the restart path after node failure.

A state is a tree of plain dicts, lists and tuples whose leaves are
arrays or scalars (``None`` is an empty subtree; any other type is a
leaf).  Leaves are keyed exactly as
``jax.tree_util.tree_flatten_with_path`` keys them — dict keys sorted,
sequence positions by index, joined with ``/`` — so the on-disk format
is ``repro.ft.checkpoint``'s and a checkpoint either package writes
restores in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil

import numpy as np


def _leaf_paths(tree, prefix: tuple = ()) -> list:
    """[(key, leaf)] in the reference's flattening order: a dict's items
    by sorted key, a list's or tuple's by position, ``None`` no leaf, and
    anything else one leaf."""
    if tree is None:
        return []
    if type(tree) is dict:
        items = ((k, tree[k]) for k in sorted(tree))
    elif type(tree) in (list, tuple):
        items = enumerate(tree)
    else:
        return [("/".join(str(p) for p in prefix), tree)]
    out = []
    for k, sub in items:
        out.extend(_leaf_paths(sub, prefix + (k,)))
    return out


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if type(like) is dict:
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if type(like) in (list, tuple):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------- save
    def save(self, step: int, state) -> pathlib.Path:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": {}}
        for key, leaf in _leaf_paths(state):
            arr = np.asarray(leaf)
            fn = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
            np.save(tmp / fn, arr)
            manifest["leaves"][key] = {
                "file": fn,
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
                "sha1": hashlib.sha1(arr.tobytes()).hexdigest(),
            }
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                    # atomic publish
        self._gc()
        return final

    # ---------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_????????"):
            if (p / "MANIFEST.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def restore(self, like_state, step: int | None = None):
        """Restore into the structure of ``like_state``.  Verifies
        checksums; falls back to older checkpoints on corruption."""
        candidates = self.steps() if step is None else [step]
        for s in reversed(candidates):
            try:
                return self._restore_one(like_state, s), s
            except Exception as e:  # noqa: BLE001 — try older checkpoint
                print(f"[ckpt] step {s} unusable ({e!r}); trying older")
        raise FileNotFoundError("no usable checkpoint found")

    def _restore_one(self, like_state, step: int):
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        leaves = {}
        for key, meta in manifest["leaves"].items():
            arr = np.load(d / meta["file"])
            if hashlib.sha1(arr.tobytes()).hexdigest() != meta["sha1"]:
                raise IOError(f"checksum mismatch for {key}")
            leaves[key] = arr
        out = []
        for key, leaf in _leaf_paths(like_state):
            if key not in leaves:
                raise KeyError(f"missing leaf {key}")
            arr = leaves[key]
            target_dtype = np.asarray(leaf).dtype if hasattr(leaf, "dtype") \
                else arr.dtype
            out.append(arr.astype(target_dtype))
        return _unflatten(like_state, iter(out))

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
