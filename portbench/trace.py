"""The traced stretch of a run: a ``torch.profiler`` window over the last
part of the measured window, its events kept in memory, and the
arithmetic that reads busy time, idle gaps, launches and kernel time from
them.

Events are plain dicts: ``cat`` (``kernel``, ``gpu_memcpy``,
``gpu_memset``, ``cuda_runtime`` or ``cpu_op``),
``name``, ``ts`` and ``dur`` in microseconds.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")
# runtime calls by which the host puts work on the device: kernels, whole
# graphs, copies and fills
LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)")


class DeviceTrace:
    """``start()`` after a synchronise, ``stop()`` after another: the
    profiler's events of the stretch and its length on the host clock."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.events: List[dict] = []
        self.window_s = 0.0
        self._t0 = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.events = [to_event(e)
                       for e in self.prof.profiler.kineto_results.events()]
        self.prof = None


RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def category(name: str, on_device: bool) -> str:
    """A profiler event's kind, from where it ran and its name (the
    profiler's own activity type is not exposed on every build)."""
    if on_device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if RUNTIME.match(name) else "cpu_op"


def to_event(e) -> dict:
    name = e.name()
    return {"cat": category(name, "CUDA" in str(e.device_type())),
            "name": name, "ts": e.start_ns() / 1e3,
            "dur": e.duration_ns() / 1e3, "tid": e.start_thread_id()}


def device_events(events: List[dict]) -> List[dict]:
    return [e for e in events if e["cat"] in DEVICE_CATS]


def intervals(events: List[dict]) -> List[tuple]:
    """The union of the device events' intervals, sorted, in us."""
    out = []
    for lo, hi in sorted((e["ts"], e["ts"] + e["dur"])
                         for e in device_events(events)):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(x) for x in out]


def busy_s(events: List[dict]) -> float:
    return sum(hi - lo for lo, hi in intervals(events)) / 1e6


def idle_share(events: List[dict], window_s: float) -> Optional[float]:
    """Percent of the stretch in which no kernel, copy or fill ran."""
    if window_s <= 0 or not device_events(events):
        return None
    return 100.0 * max(0.0, 1.0 - busy_s(events) / window_s)


def launches(events: List[dict]) -> int:
    """Device ops the host launched: kernel and graph launches, copies and
    fills (a graph launch counts once, whatever it runs)."""
    return sum(1 for e in events if e["cat"] == "cuda_runtime"
               and LAUNCH.match(e["name"]))


def copy_s(events: List[dict], direction: str = "HtoD") -> float:
    return sum(e["dur"] for e in events
               if e["cat"] == "gpu_memcpy" and direction in e["name"]) / 1e6


def kernel_s(events: List[dict], pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(e["dur"] for e in events
               if e["cat"] == "kernel" and rx.search(e["name"])) / 1e6


def top_ops(events: List[dict], n: int = 10) -> List[list]:
    """[[device op name, seconds]] of the ops that took most time."""
    sums: Dict[str, float] = {}
    for e in device_events(events):
        sums[e["name"][:160]] = sums.get(e["name"][:160], 0.0) + e["dur"]
    ranked = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
    return [[name, us / 1e6] for name, us in ranked]


def idle_gaps(events: List[dict], n: int = 10) -> List[list]:
    """[[what the host was doing, seconds]] of the longest gaps between
    device work: the innermost host event that covers the gap's middle,
    or, where the host ran Python between traced calls, the calls before
    and after."""
    spans = intervals(events)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(spans, spans[1:])
                   if b[0] > a[1]), reverse=True)[:n]
    host = [e for e in events if e["cat"] in HOST_CATS]
    out = []
    for length, lo, hi in gaps:
        mid = (lo + hi) / 2
        covering = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        if covering:
            name = min(covering, key=lambda e: e["dur"])["name"][:120]
        else:
            before = [e for e in host if e["ts"] + e["dur"] < mid]
            after = [e for e in host if e["ts"] > mid]
            name = "python between {} and {}".format(
                max(before, key=lambda e: e["ts"] + e["dur"])["name"][:56]
                if before else "start",
                min(after, key=lambda e: e["ts"])["name"][:56]
                if after else "end")
        out.append([name, length / 1e6])
    return out
