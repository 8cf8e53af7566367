"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Sets up the cell (weights and inputs from the seed, the program built and
warmed up), measures for ``--seconds``, compares what the timed path
produced with the plain reference, and prints the result as the last line
of standard output: the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics from a profiler window over the window's last stretch
with ``--trace 1``.  The numbers compared, each with its limit, are the
last lines of standard error.  Needs a CUDA card; exits 2 without one and
3 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(CHECKOUT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # kernel caches at fixed paths inside the checkout
    cache = CHECKOUT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch

    from portbench import harness
    chips = harness.workload(harness.manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"portbench: card {harness.card_text('cuda:0')}", file=sys.stderr)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"portbench check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
