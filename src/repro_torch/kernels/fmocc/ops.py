"""SMEM extension rounds through the fused fmocc CUDA kernel
(``csrc/fmocc.cu``).

``ext_round`` is the wrapper: the backward (or forward) extension of a
batch of bi-intervals, every occ lookup included.  For tensors on the
CPU it runs the plain PyTorch version (``ref.ext_round_ref``); for
tensors on a CUDA device it launches the round kernel of the requested
bucket layout, once, and raises if the library does not build or the
launch fails; any other device raises.

``occ`` is Occ(c, i) alone, for CPU tensors (the plain version); there
is no standalone occ kernel, so it raises for any other device.

``OccConfig`` names the round kernel SMEM runs on one device: its bucket
layout and ``block`` (threads per block), which take the place of the
Pallas layout and query tile ``qb``; the engine's sweep picks them.

Replaces ``repro.kernels.fmocc.ops`` (``_occ_impl``,
``_backward_ext_impl`` / ``backward_ext_pallas``) and the two Pallas
kernels behind them, as one jitted SMEM round of ``repro.core.smem``
runs them.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import obs
from ...core.fmindex import FMArrays
from .. import build
from .ref import ext_round_ref, occ_ref

#: occ-bucket layouts: eta=32 (one byte per base) and eta=128 (2-bit packed)
LAYOUTS = ("eta32", "eta128")
#: extension directions of a round
DIRECTIONS = ("bwd", "fwd")
BLOCK = 256
#: (layout, block) where no sweep has timed the candidates (the CPU)
DEFAULT_CANDIDATE = ("eta32", BLOCK)


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown occ layout {layout!r} "
                         f"(known: {', '.join(LAYOUTS)})")


@dataclasses.dataclass(frozen=True)
class OccConfig:
    """The round kernel SMEM runs: bucket ``layout`` and ``block``, on
    ``device``."""
    layout: str
    block: int
    device: str


def occ(fm: FMArrays, c: torch.Tensor, i: torch.Tensor, *,
        layout: str = "eta32") -> torch.Tensor:
    """Occ(c, i) for tensors ``c`` (0..3) and ``i`` (-1..N-1) of one
    shape on the CPU, by the plain version of ``layout``."""
    _check_layout(layout)
    if c.device.type != "cpu":
        raise RuntimeError(f"fmocc occ has no kernel for device {c.device}: "
                           f"a round's lookups run inside ext_round")
    return occ_ref(fm, c, i, layout=layout)


def ext_round(fm: FMArrays, which: str, k: torch.Tensor, l: torch.Tensor,
              s: torch.Tensor, c: torch.Tensor, *, layout: str = "eta32",
              block: int = BLOCK) -> torch.Tensor:
    """One extension round: ``which`` "bwd" (``backward_ext_v``) or "fwd"
    (``forward_ext_v``) of the bi-intervals (k, l, s) by bases c, tensors
    of one shape on the device of ``fm``.  Returns int32 (3, ...): the
    rows k', l', s', so ``k2, l2, s2 = ext_round(...)`` unpacks them.

    On a CUDA device the inputs must be contiguous int32, and their
    values are not checked (that would take a device-to-host read per
    round): an interval outside [0, N] reads outside the index tables,
    as it would index outside them on the CPU path."""
    _check_layout(layout)
    if which not in DIRECTIONS:
        raise ValueError(f"unknown extension direction {which!r}")
    dev = k.device
    if dev.type == "cpu":
        return ext_round_ref(fm, which, k, l, s, c, layout=layout)
    if dev.type != "cuda":
        raise RuntimeError(f"fmocc has no kernel for device {dev}")
    if not obs.enabled():
        return _ext_round_cuda(fm, which, k, l, s, c, layout, block)
    with obs.span("kernel.fmocc", cat="kernel", entries=k.numel()):
        obs.count("kernel_fmocc_dispatches")
        return _ext_round_cuda(fm, which, k, l, s, c, layout, block)


def _ext_round_cuda(fm: FMArrays, which: str, k, l, s, c, layout: str,
                    block: int) -> torch.Tensor:
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"block {block} must be a multiple of 32 in [32, 1024]")
    counts, rows = ((fm.occ32_counts, fm.occ32_bytes) if layout == "eta32"
                    else (fm.occ128_counts, fm.occ128_packed))
    dev = k.device
    for name, t in (("l", l), ("s", s), ("c", c)):
        if t.shape != k.shape:
            raise ValueError(f"fmocc: {name} {tuple(t.shape)} and k "
                             f"{tuple(k.shape)} differ")
    for name, t in (("k", k), ("l", l), ("s", s), ("c", c)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"fmocc: {name} must be contiguous int32 on {dev}")
    for name, t in (("counts", counts), ("rows", rows), ("C", fm.C),
                    ("primary", fm.primary)):
        if t.device != dev:
            raise ValueError(f"fmocc: {name} is on {t.device}, k on {dev}")
    if counts.dtype != torch.int32 or rows.dtype != torch.uint8 or \
            fm.C.dtype != torch.int32 or fm.primary.dtype != torch.int32 or \
            not counts.is_contiguous() or not rows.is_contiguous() or \
            not fm.C.is_contiguous() or counts.shape[1:] != (4,) or \
            rows.shape[1:] != (32,) or counts.data_ptr() % 16 or \
            rows.data_ptr() % 16:
        raise ValueError("fmocc: index tensors must be contiguous 16-byte "
                         "aligned (nb, 4) int32 counts and (nb, 32) uint8 "
                         "rows, with int32 C and primary")
    n = k.numel()
    if 3 * n >= 2 ** 31:
        raise ValueError(f"fmocc: {n} entries exceed one launch's int32 count")
    out = torch.empty((3, *k.shape), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    name = f"fmocc_ext_{layout}"
    entry = getattr(build.library(), name)
    args = (k.data_ptr(), l.data_ptr(), s.data_ptr(), c.data_ptr(),
            counts.data_ptr(), rows.data_ptr(), fm.C.data_ptr(),
            fm.primary.data_ptr(), out.data_ptr(), n, int(which == "fwd"),
            block, torch.cuda.current_stream(dev).cuda_stream)
    with obs.device_span("fmocc", dev, build.GATE):
        err = entry(*args)
    build.check(err, name)
    build.count_launch(name)
    return out

