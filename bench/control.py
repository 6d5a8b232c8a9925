"""The control of the comparison: the reference with one guarantee broken,
put in the program's place, has to come out not correct.

    python3 bench/control.py --workload <name> --seeds <n> [<n> ...] \\
        [--chunks 8]

The control is the reference whose BSW reports no end-to-end score
(``gscore``): every extension then ends in a local clip, which breaks
bwa's clipping penalty (``-L 5,5``) that the configuration states.  It is
what a kernel that drops the end-to-end bookkeeping to save work would
give.  For each seed, a window of ``--chunks`` chunks is assumed, the
run's sample is drawn from the seed as a run draws it, the control maps
it, and the run's comparison reads how many of its reads differ from the
reference.  Prints one JSON line a seed.  The benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def control_reading(name: str, seed: int, chunks: int, device,
                    root: pathlib.Path = ROOT) -> dict:
    """The control's compared numbers on the sample of seed ``seed``."""
    from bench import harness
    cell = harness.load_cell(name, root)
    n_items = chunks * cell.chunk_items
    pick = harness.sample(cell, seed, n_items)
    t0 = time.perf_counter()
    _, head, lines = harness.expected(cell, seed, pick, device,
                                      control=True)
    t1 = time.perf_counter()
    checks = harness.compare(cell, seed, "\n".join(head + lines), n_items,
                             device)
    return {"workload": name, "seed": seed,
            "reads_compared": checks["reads_compared"]["value"],
            "reads_differing": checks["reads_differing"]["value"],
            "correct": checks["reads_differing"]["value"] <= 0,
            "control_s": t1 - t0,
            "reference_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--chunks", type=int, default=8)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(control_reading(args.workload, seed, args.chunks,
                                         torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
