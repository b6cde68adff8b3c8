"""The control of `correct` and the planted faults that give each number
compared its upper reading: the plain reference put in the program's
place, served through the same loop, set-up and comparison as a
benchmark run, with one guarantee broken:

  control  the reverse complement is never looked up (no strand merge);
  half     each chunk answers only its first half of reads (lines lost);
  text     the output goes through the CLI's Python formatter, not the
           bytes of format_pairs (the branch a real file takes).

Each seed prints one JSON line with the numbers compared.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 5 [--variant control]
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark.harness import run_cell  # noqa: E402

VARIANTS = {"control": {"rc": False}, "half": {"keep": 0.5}, "text": {}}


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variant", default="control", choices=sorted(VARIANTS))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("control: no CUDA device\n")
        return 2
    if args.variant == "text":
        from finito_tpu_torch import native

        native.format_pairs = lambda *a: None
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = run_cell(args.workload, seed, args.seconds, False, device=args.device,
                                  reference_engine=VARIANTS[args.variant])
        print(json.dumps({"workload": args.workload, "seed": seed, "variant": args.variant,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "failed": result["failed"], "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
