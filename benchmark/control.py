"""The readings that the limits of ``correct`` are set from: for each seed,
one run of a cell at its own size and load (a short window), the numbers
the check compares for the program, and the same numbers for the control,
the plain reference computed in bfloat16 and put in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 10

Prints one JSON line a seed. Not run by the benchmark's own runs."""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as bench_run  # sets the caches and the paths


def main() -> int:
    from pathlib import Path

    import torch

    import compare
    import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        spec = harness.load_spec(args.workload, Path(bench_run.ROOT))
        run = harness.Run(spec, seed, args.seconds, False, time.time(), args.device)
        run.setup()
        run.window()
        run.close()
        program, info = compare.numbers(run)
        control, cinfo = compare.numbers(run, control=True)
        print(json.dumps(dict(workload=args.workload, seed=seed, program=program, control=control,
                              samples={k: v for k, v in info.items() if not isinstance(v, (list, dict))},
                              detail=info, control_detail=cinfo)), flush=True)
        del run
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
