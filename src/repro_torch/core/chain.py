"""Seed chaining + chain filtering (port of bwa mem_chain / mem_chain_flt).

Chaining is NOT one of the paper's three optimized kernels (6% of runtime,
Table 1); it is shared verbatim between the baseline and optimized
pipelines, which keeps the identical-output property trivially true for
this stage.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import obs


def _block_of(edges: np.ndarray, pos: int) -> int:
    """Index of the contig block (see core.contig) containing ``pos``."""
    return int(np.searchsorted(edges, pos, side="right"))


@dataclasses.dataclass(frozen=True)
class ChainOptions:
    w: int = 100                 # band width used in the merge test
    max_chain_gap: int = 10000
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    min_seed_len: int = 19
    min_chain_weight: int = 0


@dataclasses.dataclass
class Chain:
    seeds: list               # [(rbeg, qbeg, len)]
    weight: int = 0

    @property
    def qbeg(self):
        return self.seeds[0][1]

    @property
    def qend(self):
        s = self.seeds[-1]
        return s[1] + s[2]

    @property
    def rbeg(self):
        return self.seeds[0][0]


def _test_and_merge(opt: ChainOptions, l_pac: int, c: Chain, seed,
                    edges=None) -> bool:
    """bwa test_and_merge: True if seed merged (or contained) into chain c."""
    rbeg, qbeg, slen = seed
    last = c.seeds[-1]
    qend = last[1] + last[2]
    rend = last[0] + last[2]
    first = c.seeds[0]
    if (qbeg >= first[1] and qbeg + slen <= qend and
            rbeg >= first[0] and rbeg + slen <= rend):
        return True                               # contained: drop silently
    if (first[0] < l_pac or last[0] < l_pac) and rbeg >= l_pac:
        return False                              # different strands
    if edges is not None and _block_of(edges, rbeg) != _block_of(edges,
                                                                 last[0]):
        return False                              # different contig blocks
    x = qbeg - last[1]
    y = rbeg - last[0]
    if (y >= 0 and x - y <= opt.w and y - x <= opt.w and
            x - last[2] < opt.max_chain_gap and y - last[2] < opt.max_chain_gap):
        c.seeds.append(seed)
        return True
    return False


def chain_weight(c: Chain) -> int:
    """bwa mem_chain_weight: min of query- and reference-coverage."""
    w_q = 0
    end = 0
    for (rb, qb, ln) in c.seeds:
        if qb >= end:
            w_q += ln
        elif qb + ln > end:
            w_q += qb + ln - end
        end = max(end, qb + ln)
    w_r = 0
    end = 0
    for (rb, qb, ln) in c.seeds:
        if rb >= end:
            w_r += ln
        elif rb + ln > end:
            w_r += rb + ln - end
        end = max(end, rb + ln)
    return min(w_q, w_r)


def chain_seeds(seeds, l_pac: int, opt: ChainOptions,
                edges=None) -> list[Chain]:
    """seeds: list of (rbeg, qbeg, len) sorted by (qbeg, ...) insertion order
    as produced by the SAL stage (bwa inserts in interval order).  We sort
    by (qbeg, rbeg, len) for determinism, then chain greedily against the
    chain with the largest rbeg <= seed.rbeg (bwa's kbtree lower-bound).
    ``edges`` (core.contig block boundaries) keeps chains from spanning
    contigs; for a single contig it is equivalent to the strand test."""
    chains: list[Chain] = []
    for seed in sorted(seeds, key=lambda s: (s[1], s[0], s[2])):
        lower = None
        best_pos = -1
        for c in chains:
            if c.rbeg <= seed[0] and c.rbeg > best_pos:
                lower, best_pos = c, c.rbeg
        if lower is None or not _test_and_merge(opt, l_pac, lower, seed,
                                                edges):
            chains.append(Chain(seeds=[seed]))
    for c in chains:
        c.weight = chain_weight(c)
    obs.count("chains_built", len(chains))
    return chains


def filter_chains(chains: list[Chain], opt: ChainOptions) -> list[Chain]:
    """bwa mem_chain_flt (single-end, no ALT contigs)."""
    chains = [c for c in chains if c.weight >= opt.min_chain_weight]
    if not chains:
        return []
    order = sorted(range(len(chains)),
                   key=lambda i: (-chains[i].weight, chains[i].rbeg,
                                  chains[i].qbeg))
    kept: list[Chain] = [chains[order[0]]]
    for oi in order[1:]:
        c = chains[oi]
        drop = False
        for k in kept:
            b = max(c.qbeg, k.qbeg)
            e = min(c.qend, k.qend)
            if e > b:                                   # query overlap
                li = c.qend - c.qbeg
                lj = k.qend - k.qbeg
                tol = int(min(li, lj) * opt.mask_level)
                if e - b >= tol:
                    if (c.weight < k.weight * opt.drop_ratio and
                            k.weight - c.weight >= opt.min_seed_len * 2):
                        drop = True
                        break
        if not drop:
            kept.append(c)
    # restore deterministic (rbeg, qbeg) order for downstream extension
    kept.sort(key=lambda c: (c.rbeg, c.qbeg))
    obs.count("chains_kept", len(kept))
    return kept
