"""conv3x3_fwd, the port of the conv probes P1-P3, alone on one CUDA device.

    python3 -m fhpe_tpu_torch.tools.profile_conv [--out PATH]

1. builds the kernels (``ops/_build.py``), prints ``nvidia-smi``'s name and
   power limit, ``-Xptxas -v``'s registers, shared memory and spills of
   ``conv3x3_fwd.cu``'s entries, and the count of tensor-core instructions
   (``HMMA`` / ``HGMMA``) in each entry's SASS (``cuobjdump -sass``, where
   the toolkit has it);
2. holds the kernel against its plain version on every case of
   ``conv_cases`` at ``RN50_SHAPES``, ``PROBE_SHAPE``, ``EDGE_SHAPES`` and
   ``WIDE_SHAPES`` (``ops/conv3x3_fwd_cases.py``) in its three modes, bf16
   -> bf16, bf16 -> float32 and float32 -> float32, TF32 off: two runs
   bit-equal, within the bars below; bf16 inputs also against a float64
   plain version;
3. times the kernel against ``F.conv2d`` (cuDNN, timed, never used) in
   bf16, in turns (kernel, ``F.conv2d``, ``F.conv2d``, kernel), each a
   profiler trace of several calls: each RN-50 shape, the probes' shape
   and the 13 calls of an RN-50 step (``RN50_COUNTS``), each beside its
   bound; at one shape also the plain version;
4. times, on the host, what the wrapper adds per call over the 13 calls:
   the bf16 plan computed afresh and looked up in its cache, and the
   wrapper's whole enqueue.

``chip_smoke.py`` calls the same functions.  Writes one JSON object to
``--out`` and prints it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops.conv3x3_fwd import bf16_plan, conv3x3_fwd, conv3x3_fwd_plain
from ..ops.conv3x3_fwd_cases import (EDGE_SHAPES, PROBE_SHAPE, RN50_COUNTS,
                                     RN50_SHAPES, WIDE_SHAPES, bf16_ulp,
                                     conv_cases, within_bf16_ulp)
from ..utils.profiling import (BF16_OPS_PER_S, bound, card_label,
                               device_ms, ptxas_report, tensor_core_counts)
from .train_parity import tf32_off

# The kernel against its plain version: float32 out within REL_TOL of
# max|y|, because only the order of the float32 sums differs (bf16
# products are exact in float32; the tensor cores' sums and the CUDA
# cores' fmaf against cuBLAS); bf16 out within one bf16 ulp of the plain
# value elementwise plus that same float32 slack, because two float32
# sums that differ by d round at most one ulp plus d apart (near 0, where
# a 9C-term sum cancels, d exceeds the ulp).
REL_TOL = 1e-5
MODES = {"bf16 -> bf16": (torch.bfloat16, None),
         "bf16 -> f32": (torch.bfloat16, torch.float32),
         "f32 -> f32": (torch.float32, None)}


def conv_bound(shapes, out_bytes: int = 2) -> dict:
    """Least time of bf16-input conv3x3_fwd calls on ``shapes`` (one entry
    per call): 18 C^2 operations per pixel at the bf16 peak, or the bytes:
    x and the weights read once (bf16), y written once (``out_bytes`` per
    value), whichever is larger."""
    nbytes = sum(2 * b * c * h * w + 2 * 9 * c * c + out_bytes * b * c * h * w
                 for b, c, h, w in shapes)
    ops = sum(18 * c * c * b * h * w for b, c, h, w in shapes)
    return bound(nbytes, ops, BF16_OPS_PER_S)


def check_cases(device) -> dict:
    """The kernel against its plain version on every ``conv_cases`` case
    at RN-50's, the probes', the edge and the wide shapes in the three
    modes, TF32 off; raises on a case beyond its bar,
    not bit-equal run to run, or not exactly 0 for zero weights.  Returns
    the number of cases and, per mode, the worst max|diff| / max|y| and
    its case, the worst max|diff| and the largest share of a case's values
    beyond one bf16 ulp; bf16 inputs' worst against a float64 plain
    version, and the plain float32 version's own."""
    shapes = RN50_SHAPES + [PROBE_SHAPE] + EDGE_SHAPES + WIDE_SHAPES
    worst = {m: {"rel": 0.0, "max_abs_err": 0.0, "beyond_ulp": 0.0,
                 "worst_case": None} for m in MODES}
    vs64 = {"kernel": 0.0, "plain": 0.0}
    bad, checked = [], 0
    with tf32_off():
        for shape in shapes:
            for name, xn, wn in conv_cases(*shape, seed=sum(shape)):
                for mode, (din, dout) in MODES.items():
                    x = torch.from_numpy(xn).to(device, din)
                    w = torch.from_numpy(wn).to(device, din)
                    k1, k2 = (conv3x3_fwd(x, w, out_dtype=dout)
                              for _ in range(2))
                    ref = conv3x3_fwd_plain(x, w, dout)
                    scale = ref.float().abs().max().item()
                    diff = (k1.float() - ref.float()).abs()
                    err = diff.max().item()
                    slack = REL_TOL * scale
                    if k1.dtype == torch.bfloat16:
                        ok = within_bf16_ulp(k1, ref, slack)
                        beyond = (diff > bf16_ulp(ref)).float().mean().item()
                    else:
                        ok, beyond = err <= slack, 0.0
                    if mode == "bf16 -> f32" and scale:
                        ref64 = conv3x3_fwd_plain(x.double(), w.double())
                        vs64["kernel"] = max(vs64["kernel"], (
                            k1.double() - ref64).abs().max().item() / scale)
                        vs64["plain"] = max(vs64["plain"], (
                            ref.double() - ref64).abs().max().item() / scale)
                    if name == "zero weights":
                        ok = ok and not bool(k1.any())
                    same = torch.equal(k1, k2)
                    acc = worst[mode]
                    rel = err / scale if scale else 0.0
                    if rel > acc["rel"]:
                        acc["rel"], acc["worst_case"] = rel, [list(shape),
                                                              name]
                    acc["max_abs_err"] = max(acc["max_abs_err"], err)
                    acc["beyond_ulp"] = max(acc["beyond_ulp"], beyond)
                    if not (ok and same):
                        bad.append((shape, name, mode, err, scale, same))
                    checked += 1
    if bad:
        raise AssertionError(f"conv3x3_fwd beyond its bars or not bit-equal"
                             f" run to run: {bad[:6]}")
    return {"cases": checked, "modes": worst, "bf16 vs float64": vs64}


def _inputs(device, shape, seed=1):
    _, xn, wn = conv_cases(*shape, seed=seed)[0]
    return tuple(torch.from_numpy(a).to(device, torch.bfloat16)
                 for a in (xn, wn))


def time_one(device, shape, out_dtype=None, iters=20) -> dict:
    """The kernel, its plain version and ``F.conv2d`` at one shape on bf16
    inputs, ``out_dtype`` bf16 (None) or float32, in turns (plain, kernel,
    kernel, plain), then ``F.conv2d`` (bf16 out: on the bf16 tensors;
    float32 out: on float32 copies, where cuDNN's TF32 products of bf16
    values are exact)."""
    x, w = _inputs(device, shape)
    x32, w32 = x.float(), w.float()

    def kernel():
        return conv3x3_fwd(x, w, out_dtype=out_dtype)

    def plain():
        return conv3x3_fwd_plain(x, w, out_dtype)

    def library():
        if out_dtype is None:
            return F.conv2d(x, w, padding=1)
        return F.conv2d(x32, w32, padding=1)

    dp1, dk1, dk2, dp2 = (device_ms(f, iters) for f in (plain, kernel,
                                                        kernel, plain))
    dl = device_ms(library, iters)
    b, c, h, wd = shape
    return {"shape": list(shape), "ms": [dk1, dk2], "plain_ms": [dp1, dp2],
            "library_ms": dl,
            **conv_bound([shape], 2 if out_dtype is None else 4),
            "tflops": 18 * c * c * b * h * wd / ((dk1 + dk2) / 2) / 1e9}


def time_shapes(device, shapes, iters=10) -> dict:
    """Device time of the kernel and of ``F.conv2d`` over ``shapes`` (one
    call per entry), bf16 in and out, in turns (kernel, ``F.conv2d``,
    ``F.conv2d``, kernel), each turn a profiler trace of ``iters``
    passes."""
    inputs = {s: _inputs(device, s) for s in set(shapes)}

    def kernel():
        for s in shapes:
            conv3x3_fwd(*inputs[s])

    def library():
        for s in shapes:
            F.conv2d(*inputs[s], padding=1)

    k1, l1, l2, k2 = (device_ms(f, iters) for f in (kernel, library,
                                                    library, kernel))
    flop = sum(18 * c * c * b * h * w for b, c, h, w in shapes)
    return {"calls": len(shapes), "gflop": flop / 1e9, "ms": [k1, k2],
            "library_ms": [l1, l2], **conv_bound(shapes),
            "tflops": flop / ((k1 + k2) / 2) / 1e9}


def rn50_step_shapes() -> list:
    """The 13 conv3x3_fwd calls of one RN-50 forward, in layer order."""
    return [s for s, n in zip(RN50_SHAPES, RN50_COUNTS) for _ in range(n)]


def time_per_shape(device) -> dict:
    """:func:`time_shapes` on each RN-50 shape and the probes' shape, one
    call each."""
    return {"x".join(map(str, s)): time_shapes(device, [s], 20)
            for s in RN50_SHAPES + [PROBE_SHAPE]}


def time_host(device, passes=5) -> dict:
    """Host µs per call over the 13 RN-50 calls, median of ``passes``
    passes: the bf16 plan computed afresh (``bf16_plan`` past its cache)
    and looked up, and the wrapper's whole enqueue (plan, allocation,
    launch), the device drained before each pass."""
    shapes = rn50_step_shapes()
    inputs = {s: _inputs(device, s) for s in set(shapes)}

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

    def plan(s):
        return s[0], s[2], s[3]

    return {"plan_us": per_call(lambda s: bf16_plan.__wrapped__(*plan(s))),
            "cached_plan_us": per_call(lambda s: bf16_plan(*plan(s))),
            "wrapper_us": per_call(lambda s: conv3x3_fwd(*inputs[s]))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_conv: needs a CUDA device")
    device = torch.device("cuda", 0)
    result = {"card": card_label(), "kind": torch.cuda.get_device_name(0)}
    print(result["card"], flush=True)
    _build.load_library()
    result["ptxas"] = ptxas_report("conv3x3_fwd.cu")
    result["tensor_core_instructions"] = tensor_core_counts("conv3x3_fwd")
    for ln in result["ptxas"]:
        print(ln, flush=True)
    print("SASS (HMMA, HGMMA):", result["tensor_core_instructions"],
          flush=True)
    result["check"] = check_cases(device)
    print("check:", result["check"], flush=True)
    result["timed"] = time_one(device, PROBE_SHAPE)
    print("timed:", result["timed"], flush=True)
    result["per_shape"] = time_per_shape(device)
    for name, r in result["per_shape"].items():
        print(f"{name}: {r}", flush=True)
    result["rn50_step_set"] = time_shapes(device, rn50_step_shapes())
    print("RN-50 step's 13 calls:", result["rn50_step_set"], flush=True)
    result["host_us_per_call"] = time_host(device)
    print("host µs per call:", result["host_us_per_call"], flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
