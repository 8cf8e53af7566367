"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own size, each through the harness's own
comparison: the program's sound readings (``program``), the precision
control (``control``: the reference computed with fp8 operands, put in
the program's place) and the program with a fault of ``faults.py``
planted (``unchanged``, ``half_batch``, ``altered``, where the cell can
have it).  One process reads every seed, so that set-up's imports and the
kernels' load are paid once.

    python3 portbench/controls.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 2] [--readings program control half_batch ...]

Prints one JSON line per seed and reading: its ``correct`` and each
number compared.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import faults, harness  # noqa: E402


def control(name: str, seed: int, seconds: float, device) -> dict:
    """A run of cell ``name`` with the fp8 reference in the program's
    place in the comparison."""
    return harness.run_cell(name, seed, seconds, False, device,
                            control=True)


def plantable(name: str) -> list:
    """The faults that cell ``name`` can have."""
    kind = harness.data("traffic", harness.workload(
        harness.manifest(), name)["traffic"])["kind"]
    return [f for f, cls in faults.FAULTS.items() if kind in cls.kinds]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--readings", nargs="+", default=["control"],
                   help="program, control, or faults of faults.py "
                   "(default: control)")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    allowed = ["program", "control", *plantable(args.workload)]
    unknown = sorted(set(args.readings) - set(allowed))
    if unknown:
        p.error(f"{unknown}: {args.workload} reads {allowed}")
    for seed in args.seeds:
        for reading in args.readings:
            t0 = time.perf_counter()
            r = harness.run_cell(
                args.workload, seed, args.seconds, False, args.device,
                fault=reading if reading in faults.FAULTS else None,
                control=reading == "control")
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": reading, "correct": r["correct"],
                              **{k: c["value"] for k, c in
                                 r["checks"].items()},
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
