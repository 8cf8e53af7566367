"""The device's idle time charged to the program's spans
(``fhpe_tpu_torch/utils/spans.py``): host events named ``fhpe.*`` in the
traced stretch, on the profiler's clock beside the device events.

The rule: find the thread of the root spans (a step's
``fhpe.train.step``, a request's ``fhpe.serve.request``); take the gaps
between the stretch's device intervals (``trace.intervals``) and, where
the first root span starts before the first device op, the time between
the two (the tracer synchronises before it starts, so the device is idle
there: a traced second of serving holds about six requests, and the
first one's planning would otherwise go uncounted); charge each instant
of a gap to the innermost ``fhpe.`` span open on that thread then, or to
``UNTRACED`` where none is open; divide by the number of root spans in
the stretch.  The charges of one stretch add up to that idle time, each
instant counted once.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import trace

PREFIX = "fhpe."
UNTRACED = "untraced"
TRAIN_ROOT = "fhpe.train.step"
SERVE_ROOT = "fhpe.serve.request"


def _innermost(spans: List[dict]) -> List[tuple]:
    """[(lo, hi, name)]: disjoint, in order, where some span of one
    thread is open, each piece named after the innermost one.  Spans of a
    thread nest; a child that the clock's rounding lets outlast its
    parent is cut at the parent's end."""
    out = []
    stack = []          # [(end, name)], innermost last
    at = None

    def close_until(t):
        nonlocal at
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > at:
                out.append((at, end, name))
            at = max(at, end)

    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        close_until(lo)
        if stack and lo > at:
            out.append((at, lo, stack[-1][1]))
        at = lo if at is None else max(at, lo)
        stack.append((min(hi, stack[-1][0]) if stack else hi, e["name"]))
    close_until(float("inf"))
    return out


def _gaps(events: List[dict], start: float) -> List[tuple]:
    """[(lo, hi)]: the idle time between device intervals, and from
    ``start`` to the first of them."""
    spans = trace.intervals(events)
    if spans and start < spans[0][0]:
        spans.insert(0, (start, start))
    return [(a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] > a[1]]


def idle_by_span(events: List[dict], root: str) -> Optional[Dict[str, float]]:
    """{span name or ``UNTRACED``: idle ms per root span}; None where no
    ``root`` span begins in the stretch."""
    spans = [e for e in events
             if e["cat"] == "cpu_op" and e["name"].startswith(PREFIX)]
    roots = [e for e in spans if e["name"] == root]
    if not roots:
        return None
    tid = roots[0]["tid"]
    roots = [e for e in roots if e["tid"] == tid]
    pieces = _innermost([e for e in spans if e["tid"] == tid])
    charged: Dict[str, float] = {UNTRACED: 0.0}
    i = 0
    for lo, hi in _gaps(events, min(e["ts"] for e in roots)):
        covered = 0.0
        while i < len(pieces) and pieces[i][1] <= lo:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < hi:
            a, b, name = pieces[j]
            part = min(b, hi) - max(a, lo)
            if part > 0:
                charged[name] = charged.get(name, 0.0) + part
                covered += part
            j += 1
        charged[UNTRACED] += (hi - lo) - covered
    return {k: v / len(roots) / 1e3 for k, v in charged.items()}


def idle_ms(r, root: str, *names: str) -> Optional[float]:
    """Idle ms per root span charged to the spans ``names`` (or
    ``UNTRACED``): 0 where they took none; None where the stretch holds
    no root span (a program without the spans)."""
    charged = idle_by_span(r["events"], root)
    return None if charged is None else sum(charged.get(n, 0.0)
                                            for n in names)
