"""The cells' index bundles, built by prefix doubling in torch.

``build(contigs)`` gives the arrays, scalars and contig table of the
port's bundle format for ``[(name, codes)]``, equal value for value,
dtype for dtype, to the reference's ``contig.build_contig_index`` (the
plain oracle the tests hold this module to).  A suffix array is unique,
so any correct construction gives the oracle's bytes; this one is fast
enough on the card for a genome of chromosome size.

* The suffix array of S = R + revcomp(R) + '$' by prefix doubling: the
  ranks of each suffix's first ``KMER`` symbols packed 3 bits a symbol
  into one int64, then rounds of one ``torch.sort`` of the int64 keys
  ``rank[i] * (N + 1) + rank[i + h] + 1`` (0 past the end), until every
  rank differs.  '$' sorts below every base and occurs once, so what
  follows it never decides an order.
* The BWT, C, the eta32 and eta128 tables and the sampled SA come from
  the SA by whole-array operations; the tables' bucket-start counts from
  counts a bucket and a cumulative sum, never an (N + 1, 4) table.

It runs on the CUDA device when there is one, on the CPU otherwise, and
imports nothing of the port.  ``genome.bundle`` runs it in a process of
its own:

    python -m bench.frozen.index_build '<genome json>' <bundle prefix>

which makes the configuration's genome (``genome.make_genome``), builds
it and writes the bundle (``genome.write_bundle``); it prints one line
of the build's seconds and memory on standard error.
"""

from __future__ import annotations

import json
import resource
import sys
import time
import types

import numpy as np
import torch

SENTINEL = 4      # the BWT byte at ``primary``
PAD = 5           # the eta32 bytes past N
OPT_ETA = 32
BASE_ETA = 128
SA_SAMPLE = 32
#: symbols of the first sort's keys: 21 x 3 bits fill an int64's 63
KMER = 21


def suffix_array(s: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(SA of ``s`` + '$' as (len(s) + 1,) int64 on ``s``'s device, sort
    rounds).  ``s``: (n,) uint8 codes 0..3; SA[0] == n, the '$' row."""
    n = s.numel() + 1
    if n >= 2 ** 31:
        raise ValueError(f"{n} suffixes: the index holds rows in int32")
    dev = s.device
    # '$' and past the end 0, bases 1..4
    sym = torch.zeros(n + KMER - 1, dtype=torch.uint8, device=dev)
    sym[:n - 1] = s + 1
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(KMER):
        key.bitwise_left_shift_(3).bitwise_or_(sym[j:j + n])
    del sym
    h, rounds = KMER, 0
    while True:
        key, sa = torch.sort(key)
        rounds += 1
        new = key[1:] != key[:-1]
        del key
        rank = torch.zeros(n, dtype=torch.int32, device=dev)
        rank[1:] = torch.cumsum(new, 0, dtype=torch.int32)
        del new
        if int(rank[-1]) == n - 1:
            return sa, rounds
        rank = torch.empty_like(rank).index_put_((sa,), rank)
        del sa
        key = rank.to(torch.int64).mul_(n + 1)
        if h < n:
            key[:n - h] += rank[h:].to(torch.int64).add_(1)
        del rank
        h *= 2


def check_suffix_array(s: torch.Tensor, sa: torch.Tensor, *,
                       block: int = 1 << 22, width: int = 32) -> int:
    """Check ``sa`` as the SA of ``s`` + '$' without the builder's logic:
    a permutation of 0..N-1, and each adjacent pair of suffixes in order,
    their symbols compared up to the first difference (``width`` at a
    time, ``block`` pairs at a time).  Raises ``AssertionError`` at the
    first fault; returns the longest common prefix of adjacent suffixes."""
    n = s.numel() + 1
    dev = s.device
    if sa.shape != (n,) or int(sa.min()) != 0 or int(sa.max()) != n - 1:
        raise AssertionError("not a permutation of 0..N-1")
    seen = torch.zeros(n, dtype=torch.bool, device=dev)
    seen[sa] = True
    if not bool(seen.all()):
        raise AssertionError("not a permutation of 0..N-1")
    del seen
    sym = torch.zeros(n + width, dtype=torch.uint8, device=dev)
    sym[:n - 1] = s + 1
    lane = torch.arange(width, device=dev)
    longest = 0
    for lo in range(0, n - 1, block):
        a = sa[lo:min(lo + block, n - 1)]
        b = sa[lo + 1:lo + 1 + a.numel()]
        off = 0
        while a.numel():
            x = sym[(a + off)[:, None] + lane]
            y = sym[(b + off)[:, None] + lane]
            differ = x != y
            done = differ.any(1)
            first = differ.to(torch.uint8).argmax(1)[done]
            xs = x[done].gather(1, first[:, None])
            ys = y[done].gather(1, first[:, None])
            if not bool((xs < ys).all()):
                raise AssertionError(f"suffixes out of order near row {lo}")
            if first.numel():
                longest = max(longest, off + int(first.max()))
            a, b = a[~done], b[~done]
            off += width
    return longest


def bucket_counts(blocks: torch.Tensor) -> torch.Tensor:
    """(nb, 4) int32 from the (nb, eta) bytes of the buckets: each base's
    count before bucket ``b``, from counts a bucket and a cumulative
    sum."""
    per = torch.stack([(blocks == c).sum(1, dtype=torch.int32)
                       for c in range(4)], 1)
    out = torch.zeros_like(per)
    out[1:] = torch.cumsum(per[:-1], 0, dtype=torch.int32)
    return out


def build(contigs, device=None) -> types.SimpleNamespace:
    """The index of ``contigs`` (``[(name, codes)]``, codes (n,) uint8
    0..3): ``PERSIST_ARRAYS`` and ``PERSIST_SCALARS`` as numpy arrays and
    ints, ``names``, ``offsets``, ``lengths``, and ``rounds`` (of the
    suffix array's sort).  ``device``: the CUDA device when there is one,
    otherwise the CPU."""
    items = list(contigs)
    if not items:
        raise ValueError("need at least one contig")
    names = tuple(str(n) for n, _ in items)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate contig names: {names}")
    arrs = [np.asarray(a, dtype=np.uint8) for _, a in items]
    lengths = np.array([len(a) for a in arrs], dtype=np.int64)
    if (lengths == 0).any():
        raise ValueError("empty contig")
    ref = np.concatenate(arrs)
    if int(ref.max()) > 3:
        raise ValueError("codes must be 0..3")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    n = len(ref)
    N = 2 * n + 1
    seq = np.concatenate([ref, (3 - ref[::-1]).astype(np.uint8)])
    S = torch.from_numpy(seq).to(dev)
    sa, rounds = suffix_array(S)
    # BWT: B[i] = S[sa[i] - 1]; the row with sa[i] == 0 holds the sentinel
    primary = int(torch.argmin(sa))
    bwt = S[(sa - 1).clamp_(min=0)]
    bwt[primary] = SENTINEL
    del S
    # C[c]: the '$' row and the bases below c (the BWT holds S's bases)
    counts = torch.stack([(bwt == c).sum() for c in range(3)])
    C = torch.cat([counts.new_ones(1), 1 + torch.cumsum(counts, 0)])
    nb32 = N // OPT_ETA + 1
    occ32_bytes = torch.full((nb32, OPT_ETA), PAD, dtype=torch.uint8,
                             device=dev)
    occ32_bytes.view(-1)[:N] = bwt
    occ32_counts = bucket_counts(occ32_bytes)
    # bucket b of eta128 starts where bucket 4b of eta32 does
    occ128_counts = occ32_counts[::BASE_ETA // OPT_ETA].contiguous()
    nb128 = N // BASE_ETA + 1
    codes = torch.zeros(nb128 * BASE_ETA, dtype=torch.uint8, device=dev)
    codes[:N] = bwt
    codes[primary] = 0    # packed as 0; the occ query corrects for it
    codes = codes.view(nb128, BASE_ETA // 4, 4)
    occ128_packed = (codes[..., 0] | (codes[..., 1] << 2)
                     | (codes[..., 2] << 4) | (codes[..., 3] << 6))
    del codes
    host = lambda t: t.cpu().numpy()
    return types.SimpleNamespace(
        n_ref=n, N=N, primary=primary, rounds=rounds,
        seq=seq, sa=host(sa), bwt=host(bwt), C=host(C),
        occ32_counts=host(occ32_counts),
        occ32_bytes=host(occ32_bytes),
        occ128_counts=host(occ128_counts), occ128_packed=host(occ128_packed),
        sa_sampled=host(sa[::SA_SAMPLE].contiguous()),
        names=names,
        offsets=np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(
            np.int64),
        lengths=lengths)


def main(argv) -> int:
    from .genome import make_genome, write_bundle
    genome, prefix = json.loads(argv[0]), argv[1]
    t0 = time.perf_counter()
    contigs = make_genome(genome)
    t1 = time.perf_counter()
    idx = build(contigs)
    t2 = time.perf_counter()
    write_bundle(prefix, idx)
    t3 = time.perf_counter()
    cuda = torch.cuda.is_available()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"index_build: N {idx.N}, device "
          f"{torch.cuda.get_device_name() if cuda else 'cpu'}, sort rounds "
          f"{idx.rounds}, genome {t1 - t0:.3f} s, build {t2 - t1:.3f} s, "
          f"write {t3 - t2:.3f} s, peak rss {rss} bytes, device peak "
          f"{torch.cuda.max_memory_allocated() if cuda else 0} bytes",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
