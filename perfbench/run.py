"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m perfbench.run ...``) from the root of a checkout. The
cell is a ``workloads`` entry of ``BENCHMARK.json``. The run sets up,
measures ``--seconds``, judges the window's outputs against the plain
reference and prints, as its last line on standard output, one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` the per-layer metrics and ``breakdown``, and last ``checks``:
each number compared, with its limit); the same numbers are the last lines
on standard error. It needs the cell's CUDA devices, and exits non-zero
with no result without them, when a module of JAX or of the JAX package
was loaded, or when the port is not in the checkout.
"""

import argparse
import json
import os
import sys

# One process with few threads: the host's small NumPy products (the
# Sinkhorn EMD) and PyTorch's CPU operations do not fan out over cores.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Run as a script, Python puts this directory first on the path, where its
# modules would shadow the standard library's; the checkout's root instead.
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main(argv=None):
    from perfbench import harness

    started = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    _, entry, _, _ = harness.cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        log("the cell needs %d CUDA devices, this host has %d"
            % (entry["chips"], torch.cuda.device_count()))
        return 2
    result, checks = harness.run(args.workload, args.seed, args.seconds,
                                 trace=bool(args.trace), device="cuda",
                                 started=started)
    loaded = harness.forbidden_modules()
    if loaded:
        log("modules of JAX or the JAX package were loaded: %s"
            % ", ".join(loaded))
        return 3
    for name, c in checks.items():
        log("check %s %r limit %r %s" % (
            name, c["value"], c["limit"],
            "ok" if c["value"] <= c["limit"] else "FAILED"))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
