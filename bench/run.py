"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It needs one CUDA device (exit 2 without
one, with no result).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, then ``setup_parts`` (the
seconds of set-up's parts; ``build_s`` is what the first run in a
checkout spends building the port's kernels and the cell's index bundle
under ``build/``, about 0 in later runs), and last ``checks``: each
number compared with the reference, beside its limit, which the last
lines of standard error repeat.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# no library the port loads may bring JAX in with it
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    import torch
    from bench import harness
    cell = harness.load_cell(args.workload, ROOT)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", root=ROOT,
                           t_process=T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in harness.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
