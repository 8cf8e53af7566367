"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is found by its name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<mix>.json`` (whose ``kind`` names
the loop in ``loops/<kind>.py`` that reads it), ``limits/<cell>.json`` and
``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import faults as fault_kinds
from .trace import DeviceTrace, idle_gaps, top_ops, busy_s

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "fhpe_tpu")


def manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def workload(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in {MANIFEST.name}")


def data(folder: str, name: str) -> dict:
    return json.loads((HERE / folder / f"{name}.json").read_text())


def reader(metric: str):
    """``read(context)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def loop_class(kind: str):
    return importlib.import_module(f"portbench.loops.{kind}").Loop


def end_to_end(m: dict, name: str) -> list:
    return [e for e in m["end_to_end"]
            if name in e.get("workloads", [name])]


def per_layer(m: dict, name: str) -> list:
    reported = {e["name"] for e in end_to_end(m, name)}
    return [p for p in m["per_layer"]
            if (name in p["workloads"] if "workloads" in p
                else p["moves"] in reported)]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def card_text(device) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def _passes(value, limit: float) -> bool:
    return value is not None and value <= limit


def _number(value):
    """A float for the result line, None where it is not finite (JSON has
    no NaN or infinity)."""
    value = float(value)
    return value if math.isfinite(value) else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, config: dict | None = None,
             traffic: dict | None = None, limits: dict | None = None,
             fault: str | None = None, control: bool = False) -> dict:
    """The result of one run of cell ``name``.  ``config``, ``traffic``
    and ``limits`` stand in for the cell's files, ``fault`` plants one of
    ``faults.FAULTS`` in the program, and ``control`` puts the reference
    computed in fp8 in the program's place in the comparison (the tests'
    and the controls' options)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    m = manifest()
    cfg = config or data("configs", workload(m, name)["config"])
    mix = traffic or data("traffic", workload(m, name)["traffic"])
    lim = limits or data("limits", name)
    planted = None if fault is None else fault_kinds.FAULTS[fault]()
    loop = loop_class(mix["kind"])(cfg, mix, seed, device, planted)
    loop.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    tracer = DeviceTrace(device) if trace else None
    stats = loop.window(seconds, tracer)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    context = None
    if trace:
        context = {"events": tracer.events, "window_s": tracer.window_s,
                   **loop.trace_context()}
    loop.free()
    readings = loop.control(lim) if control else loop.check(lim)
    checks = {k: {"value": _number(v), "limit": lim[k]}
              for k, v in readings.items()}

    values = {**stats["e2e"], "setup_s": setup_s}
    if trace:
        metrics = {}
        for p in per_layer(m, name):
            v = reader(p["name"])(context)
            if v is not None:
                metrics[p["name"]] = {"value": _number(v),
                                      "unit": p["unit"]}
    else:
        metrics = {e["name"]: {"value": _number(values[e["name"]]),
                               "unit": e["unit"]}
                   for e in end_to_end(m, name)}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(_passes(c["value"], c["limit"])
                             for c in checks.values()),
              "attempted": stats["attempted"], "failed": stats["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = busy_s(tracer.events)
        dev["window_s"] = tracer.window_s
        result["breakdown"] = {"device_ops": top_ops(tracer.events),
                               "idle_gaps": idle_gaps(tracer.events)}
    result["checks"] = checks
    return result
