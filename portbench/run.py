"""Run one cell of the benchmark once, on the chip this process runs on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It needs CUDA and as many cards as the
cell asks for, and exits with another code than 0, printing no result,
without them.  The last line of standard output is the result's JSON; the
compared numbers and their limits are the last lines of standard error.
``--control 1`` (never passed by the benchmark's own runs) puts the control
in the program's place: ``correct`` is decided from the reference computed
in float8 at the same served positions, by the same limit, and a sound
benchmark reads it false.
"""

import time

T_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's compiled caches stay at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")


def process_start() -> float:
    """This process's start on the wall clock, from /proc (its own run
    otherwise)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return T_WALL


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    t_process = min(process_start(), T_WALL)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args()

    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ["USE_FLAX"] = "0"
    sys.path[0] = ROOT
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from portbench import harness

    cell, conf, mix, limits = harness.cell_parts(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {power_limit()}", file=sys.stderr)
    per_layer = [m for m in bench["per_layer"]
                 if args.workload in m.get("workloads", [args.workload])]
    e2e = [m for m in bench["end_to_end"]
           if args.workload in m.get("workloads", [args.workload])]
    res = harness.run_cell(conf, mix, limits, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device=torch.device("cuda"),
                           t_process=t_process,
                           control=harness.reference.fp8_rows if args.control else None,
                           per_layer=per_layer, end_to_end=e2e)
    if res["forbidden_loaded"]:
        print(f"portbench: loaded after the window: {', '.join(res['forbidden_loaded'])}",
              file=sys.stderr)
        return 3
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": res["device"]}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    if "control" in res:
        out["control"] = res["control"]
    out["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
