"""Occ(c, i) through the fmocc CUDA kernels (``csrc/fmocc.cu``).

``occ`` is the wrapper.  For tensors on the CPU it runs the plain
PyTorch version (``ref.occ_ref``); for tensors on a CUDA device it
launches the kernel of the requested bucket layout and raises if the
library does not build or the launch fails; any other device raises.

Replaces ``repro.kernels.fmocc.ops._occ_impl`` and the two Pallas
kernels behind it.  ``block`` (threads per block) takes the place of the
Pallas query tile ``qb``; the engine's sweep picks it.
"""

from __future__ import annotations

import functools

import torch

from ... import obs
from ...core.fmindex import FMArrays
from .. import build
from .ref import occ_ref

#: occ-bucket layouts: eta=32 (one byte per base) and eta=128 (2-bit packed)
LAYOUTS = ("eta32", "eta128")
BLOCK = 256

#: kernel launches by kernel name (reset by kernels.reset_launch_counts)
LAUNCHES = {"fmocc_eta32": 0, "fmocc_eta128": 0}


def occ(fm: FMArrays, c: torch.Tensor, i: torch.Tensor, *,
        layout: str = "eta32", block: int = BLOCK) -> torch.Tensor:
    """Occ(c, i) for int32 tensors ``c`` (0..3) and ``i`` (-1..N-1) of
    one shape, on the device of ``fm``; returns int32 of that shape.

    On a CUDA device the values of ``c`` and ``i`` are not checked (that
    would take a device-to-host read per call): out-of-range values read
    outside the index tables, as they would index outside them on the
    CPU path."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown occ layout {layout!r} "
                         f"(known: {', '.join(LAYOUTS)})")
    if c.device.type == "cpu":
        return occ_ref(fm, c, i, layout=layout)
    if c.device.type != "cuda":
        raise RuntimeError(f"fmocc has no kernel for device {c.device}")
    if not obs.enabled():
        return _occ_cuda(fm, c, i, layout, block)
    with obs.span("kernel.fmocc", cat="kernel", queries=c.numel()):
        obs.count("kernel_fmocc_dispatches")
        out = _occ_cuda(fm, c, i, layout, block)
        torch.cuda.synchronize(c.device)
    return out


def _occ_cuda(fm: FMArrays, c, i, layout: str, block: int) -> torch.Tensor:
    if c.shape != i.shape:
        raise ValueError(f"c {tuple(c.shape)} and i {tuple(i.shape)} differ")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"block {block} must be a multiple of 32 in [32, 1024]")
    counts, rows = ((fm.occ32_counts, fm.occ32_bytes) if layout == "eta32"
                    else (fm.occ128_counts, fm.occ128_packed))
    dev = c.device
    for name, t in (("i", i), ("counts", counts), ("rows", rows),
                    ("primary", fm.primary)):
        if t.device != dev:
            raise ValueError(f"fmocc: {name} is on {t.device}, c on {dev}")
    if counts.dtype != torch.int32 or rows.dtype != torch.uint8 or \
            not counts.is_contiguous() or not rows.is_contiguous() or \
            counts.shape[1:] != (4,) or rows.shape[1:] != (32,) or \
            rows.data_ptr() % 16:
        raise ValueError("fmocc: index tensors must be contiguous (nb, 4) "
                         "int32 counts and 16-byte aligned (nb, 32) uint8 "
                         "rows")
    cf = c.reshape(-1).to(torch.int32).contiguous()
    i_f = i.reshape(-1).to(torch.int32).contiguous()
    T = cf.numel()
    if T >= 2 ** 31:
        raise ValueError(f"fmocc: {T} queries exceed one launch's int32 count")
    out = torch.empty(T, dtype=torch.int32, device=dev)
    if T == 0:
        return out.reshape(c.shape)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = f"fmocc_{layout}"
    if layout == "eta32":
        err = lib.fmocc_eta32(cf.data_ptr(), i_f.data_ptr(), counts.data_ptr(),
                              rows.data_ptr(), out.data_ptr(), T, block, stream)
    else:
        err = lib.fmocc_eta128(cf.data_ptr(), i_f.data_ptr(),
                               counts.data_ptr(), rows.data_ptr(),
                               fm.primary.data_ptr(), out.data_ptr(), T,
                               block, stream)
    build.check(err, name)
    LAUNCHES[name] += 1
    return out.reshape(c.shape)


def make_occ_fn(layout: str = "eta32", block: int = BLOCK,
                device="cuda"):
    """One stable ``occ_fn(fm, c, i)`` per (layout, block, device), with
    the signature of ``core.fmindex.occ_opt_v`` — what SMEM rounds call.
    ``occ_fn.device`` tells ``core.smem`` where to run the round."""
    return _make_occ_fn(layout, int(block), str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _make_occ_fn(layout: str, block: int, device: str):
    def occ_fn(fm: FMArrays, c: torch.Tensor, i: torch.Tensor):
        return occ(fm, c, i, layout=layout, block=block)
    occ_fn.__name__ = occ_fn.__qualname__ = f"occ_{layout}_b{block}"
    occ_fn.layout = layout
    occ_fn.block = block
    occ_fn.device = torch.device(device)
    return occ_fn
