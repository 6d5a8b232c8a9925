"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into ONE shared
library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``build/repro_torch/`` at the root of the checkout, named by a
content hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads at once.

Nothing is built at import time: ``library()`` builds on its first call,
which is the first kernel launch on a CUDA tensor.

It also holds what every wrapper shares: the one launch counter
(``LAUNCHES``, ``count_launch``), the launch gate (``GATE``), the
host-to-device copy ``to_device`` and each thread's pinned staging
buffer (``staging``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
#: ptxas resource report (registers, spills) of each kernel, kept in build_log
PTXAS_VERBOSE = ("-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> argtypes (every one returns cudaError_t as int)
SIGNATURES = {
    "fmocc_ext_eta32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "fmocc_ext_eta128": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "bsw_extend": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _P, _I, _I, _I, _P),
    "galign": (_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
               _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "galign_occupancy": (_I, _I, _P),
    "diagseed": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    "gate_alloc": (_P, _P),
    "gate_wait": (_P, _P, ctypes.c_uint),
    "fmocc_load": (),
    "bsw_load": (),
    "galign_load": (),
    "diagseed_load": (),
}
#: entry points that load a source's kernels (LaunchGate calls them all)
LOADERS = tuple(name for name in SIGNATURES if name.endswith("_load"))

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
#: guards ``LAUNCHES``: shards on worker threads launch at once, and
#: ``LAUNCHES[name] += 1`` is a read-modify-write
LAUNCH_LOCK = threading.Lock()
#: kernel launches by kernel name (reset by kernels.reset_launch_counts)
LAUNCHES = dict.fromkeys(("fmocc_ext_eta32", "fmocc_ext_eta128", "bsw",
                          "galign", "diagseed"), 0)
#: nvcc's output of the last build (the ptxas resource report)
build_log = ""


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def _build(target: pathlib.Path) -> str:
    cc = nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [cc, *NVCC_FLAGS, *PTXAS_VERBOSE, "-c", str(src), "-o",
                 str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed, logs = [], []
        for src, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"{src.name}:\n{log}")
            if proc.returncode != 0:
                failed.append(logs[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = pathlib.Path(tmp) / target.name
        link = subprocess.run([cc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                               *map(str, objs), "-lcuda"],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, target)
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB, build_log
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            build_log = _build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]`` under ``LAUNCH_LOCK``."""
    with LAUNCH_LOCK:
        LAUNCHES[name] += 1


def to_device(a: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev``; on a card through pinned memory without
    waiting for the copy (the stream orders it)."""
    x = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(dev).type != "cuda":
        return x.to(dev)
    return x.pin_memory().to(dev, non_blocking=True)


_STAGING = threading.local()


def staging(n: int) -> torch.Tensor:
    """This thread's pinned host buffer of at least ``n`` bytes (uint8),
    reused across calls and grown (at least doubled) on demand.  A caller
    packs into it and copies it to the card without waiting; the copy has
    to be done (say, a readback on the same stream) before the thread's
    next call writes the buffer again."""
    buf = getattr(_STAGING, "buf", None)
    if buf is None or buf.numel() < n:
        grown = max(n, 2 * buf.numel()) if buf is not None else n
        buf = _STAGING.buf = torch.empty(grown, dtype=torch.uint8,
                                         pin_memory=True)
    return buf


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


class LaunchGate:
    """The gate of ``csrc/gate.cu`` for ``obs.device_span``: ``hold``
    makes the stream wait until the word reaches a new number, and
    ``release`` writes it once the launch and its end event are
    enqueued, so the events time the kernel rather than the host's launch
    path (tens of µs a launch, over kernels of 2-70 µs).  Numbers rise
    under a lock and the word never goes back, so a later hold's release
    frees an earlier hold too.  Nothing between a hold and its release may
    wait for the device, or the stream waits for ever: the first hold
    loads every kernel of the library (``LOADERS``), since under lazy
    module loading a kernel's first launch waits for the device."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0
        self._word: ctypes.c_uint | None = None
        self._dev = 0

    def hold(self, stream) -> int:
        lib = library()
        with self._lock:
            if self._word is None:
                for name in LOADERS:
                    check(getattr(lib, name)(), name)
                host, dev = ctypes.c_void_p(), ctypes.c_void_p()
                check(lib.gate_alloc(ctypes.byref(host), ctypes.byref(dev)),
                      "gate_alloc")
                self._word = ctypes.c_uint.from_address(host.value)
                self._dev = dev.value
            self._value = (self._value + 1) & 0xFFFFFFFF
            value = self._value
        check(lib.gate_wait(stream.cuda_stream, self._dev, value),
              "gate_wait")
        return value

    def release(self, value: int) -> None:
        with self._lock:
            # the wait compares as int32 differences, so does the word
            if (value - self._word.value) & 0xFFFFFFFF < 1 << 31:
                self._word.value = value


#: the gate every timed launch of the library holds
GATE = LaunchGate()
