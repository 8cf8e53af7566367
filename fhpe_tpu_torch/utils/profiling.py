"""Device time read from ``torch.profiler`` traces, and what the card's
toolchain says about the built kernels (CUDA only).

The port's serve step is bound by the host's dispatch (``PERF.md``), so
CUDA events around a loop of calls time the host, not the device.  These
helpers read the device's own activity from a profiler trace instead.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, List

import torch

_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "traces"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACES = 3   # profiler traces device_ms takes before it gives up


def device_events(fn: Callable[[], object], iters: int = 1) -> List[dict]:
    """Run ``fn`` ``iters`` times under the profiler; return the trace's
    device events (chrome-trace dicts: ``cat``, ``name``, ``ts``, ``dur``
    in microseconds)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    _TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = _TRACE_DIR / f"trace_{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    return [e for e in events if e.get("cat") in DEVICE_CATEGORIES]


def device_ms(fn: Callable[[], object], iters: int = 100) -> float:
    """Kernel time per call of ``fn``: the summed durations of the kernels
    it launches, host time excluded.  One untraced call first.

    A profiler trace on the card has been seen to hold no device activity
    at all (cause unknown); such a trace is taken again, up to ``TRACES``
    in all.
    """
    fn()
    for _ in range(TRACES):
        events = device_events(fn, iters)
        us = sum(float(e["dur"]) for e in events if e["cat"] == "kernel")
        if us > 0:
            return us / iters / 1e3
    raise RuntimeError(f"profiler recorded no kernel time in {TRACES} "
                       f"traces")


def busy_ms(events: List[dict]) -> float:
    """Time the device was busy: the union of the events' intervals, ms."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total / 1e3


def card_label() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(source: str) -> list:
    """``-Xptxas -v`` lines (entry, registers, shared memory, spills) of
    ``ops/csrc/<source>`` compiled with the build's flags."""
    from ..ops import _build
    src = _build._CSRC / source
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", str(Path(tmp) / "kernel.o"), str(src)],
            capture_output=True, text=True, check=True, timeout=600)
    lines = (out.stdout + out.stderr).splitlines()
    keep = ("Compiling entry", "Used", "spill")
    return [ln.strip() for ln in lines if any(k in ln for k in keep)]


def tensor_core_counts(match: str) -> dict:
    """{entry: (HMMA, HGMMA) instructions} of every entry of the built
    library whose name holds ``match``, from its SASS, or {} when the
    toolkit has no cuobjdump."""
    from ..ops import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if match in m.group(1) else None
            if name:
                counts[name] = [0, 0]
        elif name:
            counts[name][0] += bool(re.search(r"\bHMMA\b", ln))
            counts[name][1] += bool(re.search(r"\bHGMMA\b", ln))
    return {k: tuple(v) for k, v in counts.items()}
