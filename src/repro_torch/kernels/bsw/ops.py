"""Banded Smith-Waterman extension through the bsw CUDA kernel
(``csrc/bsw.cu``).

``bsw_call`` is the wrapper over packed task arrays.  For tensors on the
CPU it runs the plain PyTorch version (``ref.bsw_ref``); for tensors on a
CUDA device it launches the kernel and raises if the library does not
build or the launch fails; any other device raises.

``bsw_extend_kernel`` is the pipeline's ``batch_fn``: it packs a block of
tasks (``core.bsw.pack_tasks``, which applies ``adjusted_band`` on the
host), moves it to ``device`` and returns one ExtResult per task.  It
replaces ``repro.kernels.bsw.ops.bsw_extend_pallas`` and the Pallas
kernel behind it.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import obs
from ...core.bsw import BSWParams, ExtResult, pack_tasks
from .. import build
from .ref import bsw_ref

#: threads (tasks) per block: small blocks spread a 256-task launch over
#: more SMs, since each thread runs a whole extension
BLOCK = 32

#: kernel launches by kernel name (reset by kernels.reset_launch_counts)
LAUNCHES = {"bsw": 0}


def bsw_call(qs: torch.Tensor, ts: torch.Tensor, qlens: torch.Tensor,
             tlens: torch.Tensor, h0s: torch.Tensor, ws: torch.Tensor,
             p: BSWParams, *, block: int = BLOCK) -> torch.Tensor:
    """qs (W, qmax) / ts (W, tmax) int32 (pad code 4); qlens, tlens, h0s,
    ws (W,) int32, ws already band-adjusted -> (6, W) int32 rows score,
    qle, tle, gtle, gscore, max_off."""
    dev = qs.device
    if dev.type == "cpu":
        return bsw_ref(qs, ts, qlens, tlens, h0s, ws, p)
    if dev.type != "cuda":
        raise RuntimeError(f"bsw has no kernel for device {dev}")
    W, qmax = qs.shape
    tmax = ts.shape[1]
    args = (qs, ts, qlens, tlens, h0s, ws)
    for name, t in zip(("qs", "ts", "qlens", "tlens", "h0s", "ws"), args):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"bsw: {name} must be contiguous int32 on {dev}")
    if ts.shape[0] != W or any(t.shape != (W,) for t in args[2:]):
        raise ValueError("bsw: task arrays disagree on W")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"block {block} must be a multiple of 32 in [32, 1024]")
    out = torch.empty((6, W), dtype=torch.int32, device=dev)
    if W == 0:
        return out
    eh_h = torch.empty((qmax + 1, W), dtype=torch.int32, device=dev)
    eh_e = torch.empty((qmax + 1, W), dtype=torch.int32, device=dev)
    lib = build.library()
    err = lib.bsw_extend(
        *(t.data_ptr() for t in args), W, qmax, tmax, p.a, p.b, p.o_del,
        p.e_del, p.o_ins, p.e_ins, p.zdrop, eh_h.data_ptr(), eh_e.data_ptr(),
        out.data_ptr(), block, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "bsw")
    LAUNCHES["bsw"] += 1
    return out


def bsw_extend_kernel(queries, targets, h0s, p: BSWParams, ws=None,
                      qmax: int | None = None, tmax: int | None = None, *,
                      device) -> list[ExtResult]:
    """One block of extension tasks on ``device`` (the ``batch_fn`` of
    ``core.bsw.bsw_extend_tasks``); ExtResults in task order."""
    packed = pack_tasks(queries, targets, h0s, p, ws, qmax, tmax)
    with obs.span("kernel.bsw", cat="kernel", lanes=len(queries)):
        obs.count("kernel_bsw_dispatches")
        dev_args = [torch.from_numpy(a).to(device) for a in packed]
        out = bsw_call(*dev_args, p).cpu().numpy()
    return [ExtResult(*(int(v) for v in col)) for col in np.asarray(out).T]
