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
tensors (on any device), arrays or scalars (``None`` is an empty
subtree; any other type is a leaf).  Leaves are keyed exactly as
``jax.tree_util.tree_flatten_with_path`` keys them — dict keys sorted,
sequence positions by index, joined with ``/`` — so the on-disk format
is ``repro.ft.checkpoint``'s and a checkpoint either package writes
restores in the other.  A bfloat16 leaf is written as the reference
writes one (numpy saves ``ml_dtypes``' bfloat16 as 2-byte ``'<V2'``
records): the same bytes, header, ``"dtype": "bfloat16"`` and checksum.
``restore`` reads those records back as bfloat16, which the reference
itself cannot (its ``astype`` has no cast from ``'<V2'``).
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil

import numpy as np
import torch

_BF16 = "bfloat16"
_BF16_DESCR = "<V2"          # numpy's header for ml_dtypes' bfloat16


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


def _host(leaf) -> tuple[np.ndarray, str]:
    """``leaf`` on the host as the array the reference writes for it, and
    its manifest dtype: a tensor's bfloat16 values as 2-byte records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), _BF16
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_npy(path, arr: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = _BF16_DESCR
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        np.ascontiguousarray(arr).tofile(f)


def _sha1(arr: np.ndarray) -> str:
    """The reference's checksum, ``sha1(arr.tobytes())``, taken over the
    array's buffer without copying it."""
    return hashlib.sha1(
        np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()


def _as_like(arr: np.ndarray, dtype: str, like):
    """A restored leaf with the type, device and dtype of ``like``."""
    if isinstance(like, torch.Tensor):
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if dtype == _BF16 else torch.from_numpy(arr))
        return t.to(device=like.device, dtype=like.dtype)
    target = np.asarray(like).dtype if hasattr(like, "dtype") else arr.dtype
    return arr.astype(target)


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
            arr, dtype = _host(leaf)
            fn = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
            _save_npy(tmp / fn, arr, dtype)
            manifest["leaves"][key] = {
                "file": fn,
                "dtype": dtype,
                "shape": list(arr.shape),
                "sha1": _sha1(arr),
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
            if _sha1(arr) != meta["sha1"]:
                raise IOError(f"checksum mismatch for {key}")
            leaves[key] = arr, meta["dtype"]
        out = []
        for key, leaf in _leaf_paths(like_state):
            if key not in leaves:
                raise KeyError(f"missing leaf {key}")
            out.append(_as_like(*leaves[key], leaf))
        return _unflatten(like_state, iter(out))

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
