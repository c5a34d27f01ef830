"""The correctness check's two readings for a cell, on the chip.

    python3 linebench/control.py --workload tornado.rtao.flight-1080p \\
        --seeds 1 2 3 --control-seeds 1 2 3 --seconds 2

For each seed it runs the cell as `run.py` does, with a window of
`--seconds`, and prints the numbers the check compares for the program;
for the seeds of `--control-seeds` also those of the control, the plain
reference computed in bfloat16 (the precision below the configuration's
float32) put in the program's place. The limits in `workloads/` are set
between the largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    from linebench.run import fix_malloc_thresholds, run_cell

    fix_malloc_thresholds()

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        ctl = torch.bfloat16 if seed in args.control_seeds else None
        r = run_cell(args.workload, seed, args.seconds, False, control=ctl)
        print(json.dumps({"seed": seed, "program": {k: c["value"] for k, c in r["checks"].items()},
                          "control": r.get("control"), "correct": r["correct"],
                          "reference_s": r["reference_s"], "frames": r["attempted"],
                          "frame_ms": r["metrics"]["frame_ms"]["value"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
