"""The reads of one run, written as FASTQ files ahead of the mapper
(``python -m bench.producer <json>``).

The argument is a JSON object: ``genome`` (the configuration's genome
section), ``traffic`` (the mix's parameters), ``seed``, ``read_len``,
``paired``, ``dir``, ``segment`` (reads, or pairs, a segment) and
``lead`` (segments kept written ahead).  The reads are those of
``frozen.reads.Simulator`` in order, with no end, cut into segments:
segment ``j`` holds reads ``j * segment`` to ``(j + 1) * segment - 1`` in
``seg<j>.<end>.fq`` (end 0, and end 1 for read 2), regular files that
appear whole (written under another name, then renamed).  While
``lead`` segments lie unread in ``dir`` this process waits; the mapper
deletes each segment it has read, and ends this process when its window
has closed.  The reads are written ahead rather than all in set-up so
that a faster program never runs out of them and a run writes little.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np

from .frozen.genome import make_genome
from .frozen.reads import BLOCK, Simulator, Traffic, fastq

#: seconds between two looks at the directory while ``lead`` segments wait
POLL_S = 0.005


def segment_path(d: pathlib.Path, j: int, end: int) -> pathlib.Path:
    return d / f"seg{j}.{end}.fq"


def segment_bytes(sim: Simulator, j: int, n: int, blocks: dict) -> list:
    """FASTQ of each end of segment ``j`` (``n`` reads or pairs);
    ``blocks`` keeps the simulator's blocks that the next segment needs."""
    lo, hi = j * n, (j + 1) * n
    need = range(lo // BLOCK, (hi - 1) // BLOCK + 1)
    for b in need:
        if b not in blocks:
            blocks[b] = sim.block(b)
    parts = [blocks[b] for b in need]
    for b in [b for b in blocks if b < need[-1]]:
        del blocks[b]
    cut = slice(lo - need[0] * BLOCK, hi - need[0] * BLOCK)
    names = sum((p[0] for p in parts), [])[cut]
    ends = [np.concatenate([p[k] for p in parts])[cut]
            for k in range(1, len(parts[0]))]
    if len(ends) == 1:
        return [fastq(names, ends[0])]
    return [fastq(names, r, f"/{e + 1}") for e, r in enumerate(ends)]


def serve(args: dict) -> None:
    sim = Simulator(make_genome(args["genome"]),
                    Traffic.from_json(args["traffic"]), int(args["seed"]),
                    read_len=int(args["read_len"]),
                    paired=bool(args["paired"]))
    d, n, lead = pathlib.Path(args["dir"]), int(args["segment"]), \
        int(args["lead"])
    blocks: dict = {}
    j = 0
    while True:
        while sum(1 for _ in d.glob("seg*.0.fq")) >= lead:
            time.sleep(POLL_S)
        for end, data in enumerate(segment_bytes(sim, j, n, blocks)):
            part = d / f"seg{j}.{end}.part"
            part.write_bytes(data)
            os.replace(part, segment_path(d, j, end))
        j += 1


def main() -> int:
    serve(json.loads(sys.argv[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
