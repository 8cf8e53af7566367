"""P4, the 3x3 filter-gradient kernel, alone on one CUDA device.

    python3 -m fhpe_tpu_torch.tools.profile_wgrad [--out PATH]

1. builds the kernels (``ops/_build.py``), prints ``nvidia-smi``'s name and
   power limit, ``-Xptxas -v``'s registers, shared memory and spills of
   ``conv_wgrad.cu``'s entries, and the count of tensor-core instructions
   (``HMMA`` / ``HGMMA``) in each entry's SASS (``cuobjdump -sass``, where
   the toolkit has it);
2. holds the kernel against its plain version on planted cases at every
   shape of the three train steps' sets (``ops/conv_wgrad_cases.py``:
   ``STEP_SHAPES``), ``EDGE_SHAPES`` and ``WIDE_SHAPES``, in bf16 and
   float32: two runs bit-equal, within ``REL_TOL`` of max|dW|; bf16 also
   against a float64 plain version;
3. times P4 against cuDNN's weight gradient
   (``tools/train_parity.py::cudnn_wgrad``, timed, never used) in bf16, in
   turns (P4, cuDNN, cuDNN, P4), each a profiler trace of several calls:
   at one shape with the plain version too, on each distinct shape of the
   step sets, and on each step's shape set with its launch counts;
4. times, on the host, what the wrapper adds per call on each step set:
   the bf16 plan computed afresh and looked up in its cache, and the
   wrapper's whole enqueue of P4.

``chip_smoke.py`` calls the same functions.  Writes one JSON object to
``--out`` and prints it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import Counter
from pathlib import Path

import torch

from ..ops import _build
from ..ops.conv_wgrad import bf16_plan, conv3x3_wgrad, conv3x3_wgrad_plain
from ..ops.conv_wgrad_cases import (EDGE_SHAPES, STEP_SHAPES, WIDE_SHAPES,
                                    planted_wgrad_cases)
from ..utils.profiling import (BF16_OPS_PER_S, bound, card_label,
                               device_ms, ptxas_report, tensor_core_counts)
from .train_parity import cudnn_wgrad

TIMED = (32, 64, 64, 64)   # the hourglass student's 64x64 conv2s, batch 32
# P4 against its plain version, as a share of max|dW|, in bf16 and float32.
# float32: the CUDA-core kernel and the plain version sum the same float32
# products in another order.  bf16: every product is exact in float32, and
# the tensor cores add them with their own float32 accumulation; on an H100
# the worst case of the step sets, edge and wide cases was 2.3e-6 of
# max|dW| (2.4e-6 against a float64 plain version, against which the plain
# float32 version itself is 7.6e-7 off), so one bar holds both.
REL_TOL = 1e-5


def check_cases(device, shapes=None) -> dict:
    """P4 against its plain version on planted cases (``noise``,
    ``border``, ``zero dy``) at ``shapes`` (by default every step shape,
    ``EDGE_SHAPES`` and ``WIDE_SHAPES``), bf16 and float32: two runs
    bit-equal, within the bars; raises on a miss.  Returns the worst
    share of max|dW| per dtype, bf16's also against float64, the worst
    absolute difference and the number of cases."""
    if shapes is None:
        shapes = sorted({s for d in STEP_SHAPES.values() for s in d}
                        ) + EDGE_SHAPES + WIDE_SHAPES
    worst = Counter()
    max_err, checked = 0.0, 0
    for shape in shapes:
        for name, x, dy in planted_wgrad_cases(*shape, seed=sum(shape)):
            for dt in (torch.bfloat16, torch.float32):
                xt = torch.from_numpy(x).to(device, dt)
                dyt = torch.from_numpy(dy).to(device, dt)
                k1, k2 = conv3x3_wgrad(xt, dyt), conv3x3_wgrad(xt, dyt)
                ref = conv3x3_wgrad_plain(xt, dyt)
                err = (k1 - ref).abs().max().item()
                scale = ref.abs().max().item()
                key = "bf16" if dt == torch.bfloat16 else "float32"
                if dt == torch.bfloat16:
                    ref64 = conv3x3_wgrad_plain(xt.double(), dyt.double())
                    err64 = (k1.double() - ref64).abs().max().item()
                    err_plain64 = (ref.double() - ref64).abs().max().item()
                    if scale:
                        worst["bf16 vs float64"] = max(
                            worst["bf16 vs float64"], err64 / scale)
                        worst["plain vs float64"] = max(
                            worst["plain vs float64"], err_plain64 / scale)
                if not (torch.equal(k1, k2) and err <= REL_TOL * scale):
                    raise AssertionError(
                        f"P4 kernel on {name} {shape} {dt}: max|diff| {err} "
                        f"against max|dW| {scale} (bar {REL_TOL} of it), "
                        f"runs bit-equal {torch.equal(k1, k2)}")
                if name == "zero dy" and k1.any():
                    raise AssertionError(f"P4 kernel on zero dy {shape} {dt}"
                                         f": dW not 0")
                max_err = max(max_err, err)
                worst[key] = max(worst[key], err / scale if scale else 0.0)
                checked += 1
    return {"cases": checked, "max_abs_err": max_err, **worst}


def bound_ms(shapes) -> tuple:
    """(least ms, "bytes" or "operations") of P4 on ``shapes`` (a list, one
    entry per call) in bf16: x and dy read once, dW written once (float32),
    2 * 9 C^2 operations per pixel at the bf16 peak."""
    nbytes = sum(2 * 2 * b * c * h * w + 4 * 9 * c * c
                 for b, c, h, w in shapes)
    ops = sum(2 * 9 * c * c * b * h * w for b, c, h, w in shapes)
    least = bound(nbytes, ops, BF16_OPS_PER_S)
    return least["bound_ms"], least["bound_by"]


def _inputs(device, shapes, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return {s: (torch.randn(s, device=device, generator=gen
                            ).to(torch.bfloat16),
                torch.randn(s, device=device, generator=gen
                            ).to(torch.bfloat16),
                torch.zeros((s[1], s[1], 3, 3), dtype=torch.bfloat16,
                            device=device))
            for s in set(shapes)}


def time_shapes(device, shapes, iters=5) -> dict:
    """Device time of P4 and of cuDNN's weight gradient over ``shapes``
    (one call per entry), bf16, in turns (P4, cuDNN, cuDNN, P4), each
    turn a profiler trace of ``iters`` passes."""
    inputs = _inputs(device, shapes)

    def p4():
        for s in shapes:
            conv3x3_wgrad(*inputs[s][:2])

    def library():
        for s in shapes:
            cudnn_wgrad(*inputs[s])

    k1, l1, l2, k2 = (device_ms(f, iters) for f in (p4, library, library,
                                                    p4))
    flop = sum(2 * 9 * c * c * b * h * w for b, c, h, w in shapes)
    lim, by = bound_ms(shapes)
    return {"calls": len(shapes), "gflop": flop / 1e9, "p4_ms": [k1, k2],
            "cudnn_ms": [l1, l2], "bound_ms": lim, "bound_by": by,
            "p4_tflops": flop / ((k1 + k2) / 2) / 1e9}


def time_step_sets(device, sets=None) -> dict:
    """:func:`time_shapes` on each train step's P4 shape set, with its
    launch counts."""
    sets = STEP_SHAPES if sets is None else sets
    return {name: time_shapes(device, [s for s, n in counts.items()
                                       for _ in range(n)])
            for name, counts in sets.items()}


def time_per_shape(device, sets=None, iters=10) -> dict:
    """P4 and cuDNN's weight gradient on each distinct shape of the step
    sets, one call each, in turns (P4, cuDNN, cuDNN, P4)."""
    sets = STEP_SHAPES if sets is None else sets
    shapes = sorted({s for counts in sets.values() for s in counts})
    out = {}
    for s in shapes:
        r = time_shapes(device, [s], iters)
        out["x".join(map(str, s))] = {
            "p4_ms": r["p4_ms"], "cudnn_ms": r["cudnn_ms"],
            "bound_ms": r["bound_ms"], "p4_tflops": r["p4_tflops"]}
    return out


def time_one(device, shape=TIMED, iters=20) -> dict:
    """P4, its plain version and cuDNN's weight gradient at one shape,
    bf16, in turns (plain, P4, P4, plain), then cuDNN."""
    _, x, dy = planted_wgrad_cases(*shape, seed=1)[0]
    x, dy = (torch.from_numpy(a).to(device, torch.bfloat16) for a in (x, dy))
    weight = torch.zeros((shape[1], shape[1], 3, 3), dtype=torch.bfloat16,
                         device=device)

    def kernel():
        return conv3x3_wgrad(x, dy)

    def plain():
        return conv3x3_wgrad_plain(x, dy)

    dp1, dk1, dk2, dp2 = (device_ms(f, iters) for f in (plain, kernel,
                                                        kernel, plain))
    dl = device_ms(lambda: cudnn_wgrad(x, dy, weight), iters)
    lim, by = bound_ms([shape])
    b, c, h, w = shape
    return {"shape": list(shape), "ms": [dk1, dk2], "plain_ms": [dp1, dp2],
            "library_ms": dl, "bound_ms": lim, "bound_by": by,
            "tflops": 2 * 9 * c * c * b * h * w / ((dk1 + dk2) / 2) / 1e9}


def time_host(device, sets=None, passes=5) -> dict:
    """Host µs per call over each step set's calls, median of ``passes``
    passes: the bf16 plan computed afresh (``bf16_plan`` past its cache)
    and looked up, and the wrapper's enqueue of P4 (plan, allocations,
    launches), the device drained before each pass."""
    sets = STEP_SHAPES if sets is None else sets
    out = {}
    for name, counts in sets.items():
        shapes = [s for s, n in counts.items() for _ in range(n)]
        inputs = _inputs(device, shapes)

        def per_call(f):
            times = []
            for _ in range(passes):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                for s in shapes:
                    f(s)
                times.append((time.perf_counter() - t0) / len(shapes) * 1e6)
            torch.cuda.synchronize(device)
            return statistics.median(times)

        out[name] = {
            "plan_us": per_call(lambda s: bf16_plan.__wrapped__(*s, 16)),
            "cached_plan_us": per_call(lambda s: bf16_plan(*s, 16)),
            "wrapper_us": per_call(
                lambda s: conv3x3_wgrad(*inputs[s][:2]))}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_wgrad: needs a CUDA device")
    device = torch.device("cuda", 0)
    result = {"card": card_label(), "kind": torch.cuda.get_device_name(0)}
    print(result["card"], flush=True)
    _build.load_library()
    result["ptxas"] = ptxas_report("conv_wgrad.cu")
    result["tensor_core_instructions"] = tensor_core_counts("wgrad")
    for ln in result["ptxas"]:
        print(ln, flush=True)
    print("SASS (HMMA, HGMMA):", result["tensor_core_instructions"],
          flush=True)
    result["check"] = check_cases(device)
    print("check:", result["check"], flush=True)
    result["timed"] = time_one(device)
    print("timed:", result["timed"], flush=True)
    result["per_shape"] = time_per_shape(device)
    for name, r in result["per_shape"].items():
        print(f"{name}: {r}", flush=True)
    result["step_sets"] = time_step_sets(device)
    for name, r in result["step_sets"].items():
        print(f"{name}: {r}", flush=True)
    result["host_us_per_call"] = time_host(device)
    print("host µs per call:", result["host_us_per_call"], flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
