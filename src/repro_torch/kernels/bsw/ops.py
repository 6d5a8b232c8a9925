"""Banded Smith-Waterman extension through the bsw CUDA kernel
(``csrc/bsw.cu``).

``bsw_call`` is the wrapper over packed task arrays.  For tensors on the
CPU it runs the plain PyTorch version (``ref.bsw_ref``); for tensors on a
CUDA device it launches the kernel, one warp a task, and raises if the
library does not build, the launch fails or one task's rows do not fit in
shared memory (ValueError); any other device raises.

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

#: dynamic shared memory one CTA may opt into on Hopper (H100, H200)
SMEM_LIMIT = 232_448
#: most tasks (warps) a CTA.  A task's rows are one dependent chain that
#: keeps one warp busy, so a launch spreads its tasks evenly over the SMs
#: (``launch_geometry``); the cap keeps the CTAs of a large launch small,
#: since a CTA holds its shared memory until its longest task ends.
MAX_WARPS = 8


def warp_smem_bytes(qmax: int) -> int:
    """Shared memory of one task: the H and E rows as int32 and the query
    codes as bytes over columns 0..qmax (H[end] is written), padded to a
    multiple of the kernel's 4 columns a lane, rounded up to 16 bytes so
    every warp's slice stays aligned for 16-byte loads."""
    ncol = -(-(qmax + 1) // 4) * 4
    return -(-9 * ncol // 16) * 16


def launch_geometry(W: int, qmax: int, sms: int) -> tuple[int, int, int]:
    """(CTAs, warps a CTA, dynamic shared-memory bytes a CTA) of a launch
    of W tasks padded to ``qmax`` on a card with ``sms`` SMs: one warp a
    task, ceil(W / sms) warps a CTA (at most ``MAX_WARPS`` and as many as
    fit in ``SMEM_LIMIT``), so the CTAs land on as many SMs as there are.
    Raises ValueError if one task's rows do not fit."""
    per_warp = warp_smem_bytes(qmax)
    if per_warp > SMEM_LIMIT:
        raise ValueError(f"bsw: qmax {qmax} needs {per_warp} bytes of shared "
                         f"memory a task, more than the {SMEM_LIMIT} a CTA "
                         f"can have")
    warps = min(MAX_WARPS, max(1, -(-W // sms)), SMEM_LIMIT // per_warp)
    return -(-W // warps), warps, warps * per_warp


def bsw_call(qs: torch.Tensor, ts: torch.Tensor, qlens: torch.Tensor,
             tlens: torch.Tensor, h0s: torch.Tensor, ws: torch.Tensor,
             p: BSWParams) -> torch.Tensor:
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
    ctas, warps, smem = launch_geometry(
        W, qmax, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((6, W), dtype=torch.int32, device=dev)
    if W == 0:
        return out
    entry = build.library().bsw_extend
    call = (*(t.data_ptr() for t in args), W, qmax, tmax, p.a, p.b, p.o_del,
            p.e_del, p.o_ins, p.e_ins, p.zdrop, out.data_ptr(), ctas, warps,
            smem // warps, torch.cuda.current_stream(dev).cuda_stream)
    with obs.device_span("bsw", dev, build.GATE):
        err = entry(*call)
    build.check(err, "bsw")
    build.count_launch("bsw")
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
