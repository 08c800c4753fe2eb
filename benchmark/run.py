"""One run of one benchmark cell of the PyTorch/CUDA port (ocn_tpu_torch).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  Prints the compared numbers and their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``.  Exits non-zero, printing no
result, without the devices, or when a module of JAX or of the JAX package
(``ocn_tpu``) is loaded once the window has closed.

``--control tf32`` is not a run of the program: it prints the numbers that
the cell's check reads when the reference computed with TF32 matmuls stands
in the program's place (how the limits were set; see PERF.md).
``--describe`` prints the graph statistics of a seed that the configuration
files record.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))
sys.path.insert(0, BENCH_DIR)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    ap.add_argument("--describe", action="store_true")
    args = ap.parse_args(argv)

    from harness import core

    wl = core.load_json("workloads", f"{args.workload}.json")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, "
              f"devices: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if args.describe or args.control:
        from harness import extra
        out = (extra.describe(args.workload, args.seed) if args.describe
               else extra.control(args.workload, args.seed))
        print(json.dumps(out), flush=True)
        return 0
    out = core.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START)
    bad = core.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
