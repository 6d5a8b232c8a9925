"""FM-index over R + revcomp(R) with the paper's two occupancy-table layouts.

The PyTorch counterpart of ``repro.core.fmindex``.  The host build
(``build_index``) and the persisted fields are the reference's own code,
so both packages produce the same bytes for the same reference; the
device view is a NamedTuple of torch tensors built
lazily, once per device, and the vectorized occ/extension functions are
plain torch.

* **eta=32** (paper §4.4): one byte per base, one 32-byte row per bucket.
  Occ(c, i) is a byte compare + popcount.
* **eta=128** (original BWA-MEM): 2-bit packed bases, 32 bytes per bucket.

All device integers are int32, as in the reference: N = 2|R|+1 must stay
below 2^31.

Index convention (0-based): S = R · revcomp(R), length 2n; the sentinel
``$`` is virtual: the suffix array is built over S+'$' (length N=2n+1) and
row ``primary`` is the row whose BWT char is '$'.  The BWT is stored as
bytes with value 4 at ``primary`` so that compares against c in {0..3}
never match it.

  Backward extension of bi-interval (k, l, s) by base c:
      k_c = C[c] + Occ(c, k-1)
      s_c = Occ(c, k+s-1) - Occ(c, k-1)
      l_3 = l + [primary in [k, k+s)] ;  l_2 = l_3 + s_3 ;
      l_1 = l_2 + s_2 ;  l_0 = l_1 + s_1
"""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple

import numpy as np
import torch

# Base codes. 0=A 1=C 2=G 3=T; 4 = sentinel marker in BWT bytes; 5 = pad.
SENTINEL = 4
PAD = 5

OPT_ETA = 32      # paper's optimized bucket size
BASE_ETA = 128    # original BWA-MEM bucket size (2-bit packed)
SA_SAMPLE = 32    # suffix-array sampling of the baseline compressed SA

I32 = torch.int32

#: Serializes FMIndex.device() lazy builds (see that method).
_DEVICE_LOCK = threading.Lock()
#: Serializes the lazy build of the host occ oracle (FMIndex.occ).
_ORACLE_LOCK = threading.Lock()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a 0..3 coded sequence (3 - c swaps A<->T, C<->G)."""
    return (3 - codes[::-1]).astype(codes.dtype)


def suffix_array(s: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (O(n log^2 n), numpy lexsort rounds).

    The caller passes the sequence WITHOUT sentinel; we treat the virtual
    sentinel as smaller than everything by ranking positions past the end
    as -1.  Returned SA has length len(s)+1 and SA[0] == len(s) ($ row).
    """
    s = np.asarray(s, dtype=np.int64)
    n = len(s) + 1  # +1 for the virtual sentinel position at index len(s)
    rank = np.full(n, -1, dtype=np.int64)
    rank[:-1] = s
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        if k < n:
            key2[: n - k] = rank[k:]
        sa = np.lexsort((key2, rank))
        new = np.empty(n, dtype=np.int64)
        diff = (rank[sa[1:]] != rank[sa[:-1]]) | (key2[sa[1:]] != key2[sa[:-1]])
        new[sa] = np.concatenate(([0], np.cumsum(diff)))
        rank = new
        if rank[sa[-1]] == n - 1:
            return sa
        k *= 2


class FMArrays(NamedTuple):
    """Device view of the index: torch tensors on one device."""
    occ32_counts: torch.Tensor   # (nb32, 4) int32 — counts up to bucket start
    occ32_bytes: torch.Tensor    # (nb32, 32) uint8 — raw BWT bytes of bucket
    occ128_counts: torch.Tensor  # (nb128, 4) int32
    occ128_packed: torch.Tensor  # (nb128, 32) uint8 — 4 bases per byte, LSB first
    C: torch.Tensor              # (4,) int32 cumulative counts (incl. +1 for $ row)
    primary: torch.Tensor        # () int32 — BWT row holding the sentinel
    sa: torch.Tensor             # (N,) int32 — UNCOMPRESSED suffix array
    sa_sampled: torch.Tensor     # (ceil(N/32),) int32 — sampled SA
    bwt: torch.Tensor            # (N,) uint8 — BWT bytes (0..3, 4 at primary)
    n_ref: torch.Tensor          # () int32 — |R|
    N: torch.Tensor              # () int32 — 2|R|+1

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    np_dtype = {torch.int32: np.int32, torch.uint8: np.uint8}[dtype]
    host = torch.from_numpy(np.require(a, np_dtype, ["C", "W"]))
    return host.to(device=device, copy=True)


@dataclasses.dataclass
class FMIndex:
    """Host-side index (numpy) + lazily-built device views."""
    n_ref: int
    N: int                      # 2*n_ref + 1 (includes virtual sentinel row)
    seq: np.ndarray             # S = R+revcomp(R), (2n,) uint8
    sa: np.ndarray              # (N,) int64
    bwt: np.ndarray             # (N,) uint8, value 4 at primary
    primary: int
    C: np.ndarray               # (4,) int64
    occ32_counts: np.ndarray
    occ32_bytes: np.ndarray
    occ128_counts: np.ndarray
    occ128_packed: np.ndarray
    sa_sampled: np.ndarray
    # (N+1, 4) int64 host occ oracle, 32 bytes a row: read by ``occ``
    # alone (the ``baseline`` engine) and built on its first call; a
    # loaded bundle starts without it
    _occ_prefix: np.ndarray | None = None
    _views: dict = dataclasses.field(default_factory=dict)

    # ---------------- host-side scalar occ (oracle) ----------------
    def occ(self, c: int, i: int) -> int:
        """Occ(c, i) = # of c in BWT[0..i]; i may be -1. Oracle path (numpy)."""
        if i < 0:
            return 0
        table = self._occ_prefix
        if table is None:
            table = self._build_oracle()
        return int(table[i + 1, c])

    def _build_oracle(self) -> np.ndarray:
        """Build the occ prefix table once, even when threads sharing the
        index (memdist's shards) ask for it at once."""
        with _ORACLE_LOCK:
            if self._occ_prefix is None:
                self._occ_prefix = occ_prefix_from_bwt(self.bwt)
            return self._occ_prefix

    def backward_ext(self, k: int, l: int, s: int, c: int):
        """Bi-interval of cX given bi-interval (k,l,s) of X. Returns (k,l,s)."""
        if c > 3:
            return (k, l, 0)
        ks, ss = [], []
        for cc in range(4):
            o1 = self.occ(cc, k - 1)
            o2 = self.occ(cc, k + s - 1)
            ks.append(int(self.C[cc]) + o1)
            ss.append(o2 - o1)
        sent = 1 if (k <= self.primary < k + s) else 0
        l3 = l + sent
        l2 = l3 + ss[3]
        l1 = l2 + ss[2]
        l0 = l1 + ss[1]
        ls = [l0, l1, l2, l3]
        return (ks[c], ls[c], ss[c])

    def forward_ext(self, k: int, l: int, s: int, c: int):
        if c > 3:
            return (k, l, 0)
        l2, k2, s2 = self.backward_ext(l, k, s, 3 - c)
        return (k2, l2, s2)

    def init_interval(self, c: int):
        """Bi-interval of the single-base string c."""
        if c > 3:
            return (0, 0, 0)
        cnt = int(self.C[c + 1] - self.C[c]) if c < 3 else int(self.N - self.C[3])
        return (int(self.C[c]), int(self.C[3 - c]), cnt)

    def sa_lookup_compressed(self, i: int) -> tuple[int, int]:
        """Baseline SAL: walk LF-mapping until a sampled row. Returns (value, steps)."""
        t = 0
        j = i
        while j % SA_SAMPLE != 0:
            # LF(j) = C[B[j]] + Occ(B[j], j-1); LF of the primary row is row 0.
            b = int(self.bwt[j])
            if b == SENTINEL:
                return (t % self.N, t)  # SA[primary] = 0 -> value = t
            j = int(self.C[b]) + self.occ(b, j - 1)
            t += 1
        return ((int(self.sa_sampled[j // SA_SAMPLE]) + t) % self.N, t)

    def device(self, dev) -> FMArrays:
        """The index's tensors on ``dev``, built on first use and cached
        per device."""
        dev = torch.device(dev)
        key = str(dev)
        view = self._views.get(key)
        if view is not None:
            return view
        # one lock for all indexes: the build is rare (once per index and
        # device) and concurrent aligner calls sharing one index must not
        # duplicate the host->device transfer
        with _DEVICE_LOCK:
            view = self._views.get(key)
            if view is not None:
                return view
            view = FMArrays(
                occ32_counts=_tensor(self.occ32_counts, I32, dev),
                occ32_bytes=_tensor(self.occ32_bytes, torch.uint8, dev),
                occ128_counts=_tensor(self.occ128_counts, I32, dev),
                occ128_packed=_tensor(self.occ128_packed, torch.uint8, dev),
                C=_tensor(self.C, I32, dev),
                primary=_tensor(self.primary, I32, dev),
                sa=_tensor(self.sa, I32, dev),
                sa_sampled=_tensor(self.sa_sampled, I32, dev),
                bwt=_tensor(self.bwt, torch.uint8, dev),
                n_ref=_tensor(self.n_ref, I32, dev),
                N=_tensor(self.N, I32, dev),
            )
            self._views[key] = view
        return view


# Fields persisted by the on-disk index bundle (io.store); the occ prefix
# oracle and the device views are derived state, built on first use.
PERSIST_ARRAYS = ("seq", "sa", "bwt", "C", "occ32_counts", "occ32_bytes",
                  "occ128_counts", "occ128_packed", "sa_sampled")
PERSIST_SCALARS = ("n_ref", "N", "primary")


def occ_prefix_from_bwt(bwt: np.ndarray) -> np.ndarray:
    """(N+1, 4) Occ prefix table from the BWT bytes (the host oracle)."""
    occ_prefix = np.zeros((len(bwt) + 1, 4), dtype=np.int64)
    for c in range(4):
        occ_prefix[1:, c] = np.cumsum(bwt == c)
    return occ_prefix


def index_from_arrays(arrays: dict, scalars: dict) -> FMIndex:
    """Reassemble an ``FMIndex`` from its persisted arrays + scalars
    (see ``PERSIST_ARRAYS``/``PERSIST_SCALARS``); the derived state is
    built on first use."""
    return FMIndex(**{k: int(scalars[k]) for k in PERSIST_SCALARS},
                   **{k: np.asarray(arrays[k]) for k in PERSIST_ARRAYS})


def build_index(ref: np.ndarray) -> FMIndex:
    """Build the full FM-index over S = ref + revcomp(ref).

    ``ref``: (n,) uint8 codes in 0..3 (ambiguous bases must be pre-replaced,
    as BWA does when building its index).
    """
    ref = np.asarray(ref, dtype=np.uint8)
    assert ref.ndim == 1 and ref.size > 0 and int(ref.max(initial=0)) <= 3
    n = len(ref)
    S = np.concatenate([ref, revcomp(ref)])          # length 2n
    sa = suffix_array(S)                             # length N = 2n+1
    N = 2 * n + 1

    # BWT: B[i] = S[sa[i]-1]; the row with sa[i]==0 gets the sentinel marker.
    bwt = np.empty(N, dtype=np.uint8)
    prev_idx = sa - 1
    mask = prev_idx >= 0
    bwt[mask] = S[prev_idx[mask]]
    primary = int(np.nonzero(~mask)[0][0])
    bwt[primary] = SENTINEL

    counts = np.bincount(S, minlength=4).astype(np.int64)
    C = np.zeros(4, dtype=np.int64)
    C[0] = 1  # the $ row
    for c in range(1, 4):
        C[c] = C[c - 1] + counts[c - 1]

    # ---- occ prefix table (host oracle only; O(N) memory x4) ----
    occ_prefix = occ_prefix_from_bwt(bwt)

    # ---- optimized layout: eta=32, one byte per base ----
    nb32 = N // OPT_ETA + 1
    padded32 = np.full(nb32 * OPT_ETA, PAD, dtype=np.uint8)
    padded32[:N] = bwt
    occ32_bytes = padded32.reshape(nb32, OPT_ETA)
    occ32_counts = occ_prefix[: nb32 * OPT_ETA : OPT_ETA, :].astype(np.int32)

    # ---- baseline layout: eta=128, 2-bit packed ----
    nb128 = N // BASE_ETA + 1
    padded128 = np.zeros(nb128 * BASE_ETA, dtype=np.uint8)
    padded128[:N] = bwt
    padded128[padded128 > 3] = 0  # sentinel/pad packed as 0; corrected in occ query
    codes = padded128.reshape(nb128, BASE_ETA)
    # 4 bases per byte, LSB-first: byte j holds codes [4j..4j+3]
    b0, b1, b2, b3 = (codes[:, i::4] for i in range(4))
    occ128_packed = (b0 | (b1 << 2) | (b2 << 4) | (b3 << 6)).astype(np.uint8)
    occ128_counts = occ_prefix[: nb128 * BASE_ETA : BASE_ETA, :].astype(np.int32)

    sa_sampled = sa[::SA_SAMPLE].copy()

    return FMIndex(
        n_ref=n, N=N, seq=S, sa=sa, bwt=bwt, primary=primary, C=C,
        occ32_counts=occ32_counts, occ32_bytes=occ32_bytes,
        occ128_counts=occ128_counts, occ128_packed=occ128_packed,
        sa_sampled=sa_sampled, _occ_prefix=occ_prefix,
    )


# ====================================================================
# Vectorized (torch) occ + extension — the plain versions of the fmocc
# kernel and the SMEM round arithmetic around it
# ====================================================================

def occ_opt_v(fm: FMArrays, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Vectorized Occ(c, i) over the eta=32 byte layout.

    c: (...,) int32 in 0..3 ; i: (...,) int32 (may be -1).  A 32-byte
    bucket row is compared against c and mask-summed.
    """
    p = (i + 1).to(I32)
    b = (p >> 5).long()
    r = p & 31
    cl = c.long()
    base = fm.occ32_counts[b, cl]
    row = fm.occ32_bytes[b]                                  # (..., 32)
    lane = torch.arange(OPT_ETA, dtype=I32, device=row.device)
    m = (lane < r[..., None]) & (row == c[..., None].to(torch.uint8))
    return base + m.sum(dim=-1, dtype=I32)


def occ_base_v(fm: FMArrays, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Vectorized Occ over the eta=128 2-bit packed layout.

    Unpacks 4 codes/byte and corrects for the primary row (the sentinel
    was packed as code 0).
    """
    p = (i + 1).to(I32)
    b = p >> 7
    r = p & 127
    base = fm.occ128_counts[b.long(), c.long()]
    packed = fm.occ128_packed[b.long()]                      # (..., 32) uint8
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=packed.device)
    codes = (packed[..., :, None] >> shifts) & 3             # (..., 32, 4)
    codes = codes.reshape(*codes.shape[:-2], BASE_ETA)
    lane = torch.arange(BASE_ETA, dtype=I32, device=packed.device)
    m = (lane < r[..., None]) & (codes == c[..., None].to(torch.uint8))
    cnt = base + m.sum(dim=-1, dtype=I32)
    # position `primary` was packed as code 0 but is the sentinel; only the
    # in-bucket partial count [b*128, p) can overcount it
    corr = ((c == 0) & (fm.primary >= (b << 7)) & (fm.primary < p)).to(I32)
    return cnt - corr


def backward_ext_v(fm: FMArrays, k, l, s, c, *, occ_fn=occ_opt_v):
    """Vectorized backward extension. k,l,s,c: (...,) int32 tensors.

    Returns (k', l', s') of string cX.  Invalid bases (c>3) yield s'=0.
    The 8 occ lookups of every entry (4 bases at k-1 and at k+s-1) go to
    ``occ_fn`` as ONE call, so a kernel-backed ``occ_fn`` launches once
    per round.
    """
    k = k.to(I32); l = l.to(I32); s = s.to(I32)
    cc = c.clamp(0, 3).long()
    batch = tuple(k.shape)
    c4 = torch.arange(4, dtype=I32, device=k.device).expand(2, *batch, 4)
    ii = torch.stack([k - 1, k + s - 1])[..., None].expand(2, *batch, 4)
    o = occ_fn(fm, c4, ii)           # (2, ..., 4)
    o1, o2 = o[0], o[1]
    ks = fm.C + o1                   # (..., 4)
    ss = o2 - o1                     # (..., 4)
    sent = ((k <= fm.primary) & (fm.primary < k + s)).to(I32)
    l3 = l + sent
    l2 = l3 + ss[..., 3]
    l1 = l2 + ss[..., 2]
    l0 = l1 + ss[..., 1]
    ls = torch.stack([l0, l1, l2, l3], dim=-1)
    take = lambda a: torch.gather(a, -1, cc[..., None])[..., 0]
    s_out = torch.where(c > 3, torch.zeros_like(s), take(ss))
    return take(ks), take(ls), s_out


def forward_ext_v(fm: FMArrays, k, l, s, c, *, occ_fn=occ_opt_v):
    cbar = torch.where(c > 3, c, 3 - c)
    l2, k2, s2 = backward_ext_v(fm, l, k, s, cbar, occ_fn=occ_fn)
    return k2, l2, s2
