"""The readings that a cell's limits are set from, taken in one process on
the card (the set-up's kernels and CUDA context paid once).

    python3 perfbench/readings.py --workload <cell> --seeds S1,S2,... \
        [--control-seeds ...] [--faults F1,F2 --fault-seeds ...] \
        [--seconds 0] [--out FILE]

Each seed is a whole run of the cell (set-up, a window of ``--seconds``,
at least one call or iteration, the check) under the program as it is,
under the control (the cell's lower precision, ``--control-seeds``) or
under each planted fault (``--faults``). One JSON line a run: the numbers
compared, the end-to-end metrics and the run's wall time, to standard
output and to ``--out``. The benchmark's own runs never run the control or
the faults.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    from perfbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    plan = [(s, False, None) for s in args.seeds]
    plan += [(s, True, None) for s in args.control_seeds]
    plan += [(s, False, f) for f in args.faults.split(",") if f
             for s in args.fault_seeds]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, control, fault in plan:
            t0 = time.perf_counter()
            result, checks = harness.run(
                args.workload, seed, args.seconds, control=control,
                fault=fault,
                started=time.clock_gettime(time.CLOCK_BOOTTIME))
            line = json.dumps({
                "workload": args.workload, "seed": seed,
                "side": "control" if control else (fault or "program"),
                "correct": result["correct"],
                "checks": {k: v["value"] for k, v in checks.items()},
                "metrics": {k: v["value"]
                            for k, v in result["metrics"].items()},
                "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                "wall_s": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
