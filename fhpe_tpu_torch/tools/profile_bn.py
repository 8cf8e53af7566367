"""The train-mode BatchNorm kernels (``ops/csrc/batch_norm.cu``) alone on
one CUDA device.

    python3 -m fhpe_tpu_torch.tools.profile_bn [--out PATH]

1. builds the kernels (``ops/_build.py``), prints ``nvidia-smi``'s name and
   power limit and ``-Xptxas -v``'s registers, shared memory and spills of
   ``batch_norm.cu``'s entries;
2. holds the kernels against their plain versions (``ops/batch_norm.py``:
   ATen's ``native_batch_norm`` then ``F.relu`` forward, the backward's
   formula in float32) at every distinct student shape of the two CNN
   steps (``ops/batch_norm_cases.py``) and ``EDGE_SHAPES``, bf16 and
   float32, the ReLU on and off, and once from an address off the 16-byte
   grid: the forward's y, batch and running statistics, the backward's dx,
   dgamma and dbeta within the bars; two calls bit-equal; the apply pass
   alone bit-equal to the forward's y;
3. times the kernels (forward, backward) against ATen's native kernels
   (``native_batch_norm`` + ``relu``, ``native_batch_norm_backward`` +
   ``threshold_backward``; yardstick only) in bf16, in turns (kernels,
   ATen, ATen, kernels), each a profiler trace of several calls: on each
   distinct step shape and on each step's set with its call counts,
   beside the bytes' bound.

``chip_smoke.py`` calls the same functions.  Writes one JSON object to
``--out`` and prints it.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import torch

from ..ops import _build
from ..ops import batch_norm as bn
from ..ops.batch_norm_cases import (EDGE_SHAPES, STEP_SHAPES, W32_CHAIN_STEP,
                                    bn_inputs)
from ..utils.profiling import (bound, card_label, device_events, device_ms,
                               ptxas_report)

MOMENTUM, EPS = 0.1, 1e-5
# The kernels against their plain versions.  Forward: y within FWD_TOL of
# max|y| (bf16: one rounding step of bf16, 2^-7 of a value, where the two
# float32 values straddle a rounding boundary; float32: the statistics'
# own rounding), the batch and running statistics within STATS_TOL
# relative.  Backward: relative L2 of dx, dgamma and dbeta within
# BWD_TOL; the plain backward takes the kernel's mean and invstd, so they
# differ by the order of float32 sums, bf16 rounding, and the few values
# whose ReLU mask flips where the two round the value before the ReLU
# apart (each moves one element of dx by its own size).
FWD_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
STATS_TOL = 1e-5
BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}


def all_shapes():
    steps = sorted({s for d in (*STEP_SHAPES.values(), W32_CHAIN_STEP)
                    for s in d})
    return steps + EDGE_SHAPES


def _tensors(shape, dtype, device, seed, offset=0):
    x, dy, gamma, beta, rm, rv = bn_inputs(*shape, seed=seed)

    def dev(a, dt=torch.float32):
        return torch.from_numpy(a).to(device, dt)
    xt = dev(x, dtype)
    if offset:   # the same values from an address off the 16-byte grid
        flat = torch.empty(xt.numel() + offset, dtype=dtype, device=device)
        flat[offset:] = xt.reshape(-1)
        xt = flat[offset:].view(shape)
    return xt, dev(dy, dtype), dev(gamma), dev(beta), dev(rm), dev(rv)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _max_rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def check_case(shape, dtype, relu, device, seed=0, offset=0) -> dict:
    """The kernels against their plain versions at one case; raises on a
    miss or on two calls that differ.  Returns the readings."""
    x, dy, gamma, beta, rm, rv = _tensors(shape, dtype, device, seed, offset)
    rm_k, rv_k, rm_p, rv_p = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    y, mean, invstd = bn.batch_norm_train(x, gamma, beta, rm_k, rv_k,
                                          MOMENTUM, EPS, relu)
    y_p, mean_p, invstd_p = bn.batch_norm_train_plain(
        x, gamma, beta, rm_p, rv_p, MOMENTUM, EPS, relu)
    again = bn.batch_norm_train(x, gamma, beta, rm.clone(), rv.clone(),
                                MOMENTUM, EPS, relu)
    applied = bn.batch_norm_apply(x, mean, invstd, gamma, beta, relu)
    grads = bn.batch_norm_backward(dy, x, mean, invstd, gamma, beta, relu)
    grads2 = bn.batch_norm_backward(dy, x, mean, invstd, gamma, beta, relu)
    grads_p = bn.batch_norm_backward_plain(dy, x, mean, invstd, gamma, beta,
                                           relu)
    name = f"{tuple(shape)} {str(dtype)[6:]} relu={relu} offset={offset}"
    if not all(torch.equal(a, b) for a, b in zip((y, mean, invstd),
                                                   again)):
        raise AssertionError(f"batch norm forward {name}: two calls differ")
    if not all(torch.equal(a, b) for a, b in zip(grads, grads2)):
        raise AssertionError(f"batch norm backward {name}: two calls differ")
    # the kernels share the forward's arithmetic (the plain versions do
    # not: ATen's forward against the formula)
    if x.is_cuda and not torch.equal(applied, y):
        raise AssertionError(f"batch norm apply {name}: not the forward's y")
    out = {"y": _max_rel(y, y_p),
           "stats": max(_max_rel(mean, mean_p), _max_rel(invstd, invstd_p),
                        _max_rel(rm_k, rm_p), _max_rel(rv_k, rv_p)),
           "dx": _rel(grads[0], grads_p[0]),
           "dgamma": _rel(grads[1], grads_p[1]),
           "dbeta": _rel(grads[2], grads_p[2]),
           "max_abs_err": (y.float() - y_p.float()).abs().max().item()}
    bars = {"y": FWD_TOL[dtype], "stats": STATS_TOL, "dx": BWD_TOL[dtype],
            "dgamma": BWD_TOL[dtype], "dbeta": BWD_TOL[dtype]}
    for k, bar in bars.items():
        if not out[k] <= bar:
            raise AssertionError(f"batch norm {name}: {k} off by {out[k]} "
                                 f"> {bar}")
    return out


def check_cases(device, shapes=None) -> dict:
    """:func:`check_case` at ``shapes`` (by default every step shape and
    ``EDGE_SHAPES``), bf16 and float32, the ReLU on and off, and the
    first shape again from an unaligned address.  Returns the worst
    reading per (dtype, number) and the number of cases."""
    shapes = all_shapes() if shapes is None else shapes
    worst, cases = {}, 0
    runs = [(s, dt, relu, 0) for s in shapes
            for dt in (torch.bfloat16, torch.float32)
            for relu in (False, True)]
    runs += [(shapes[0], dt, True, 1) for dt in (torch.bfloat16,
                                                 torch.float32)]
    for k, (shape, dtype, relu, offset) in enumerate(runs):
        got = check_case(shape, dtype, relu, device, seed=k, offset=offset)
        for key, v in got.items():
            wk = f"{str(dtype)[6:]} {key}"
            worst[wk] = max(worst.get(wk, 0.0), v)
        cases += 1
    return {"cases": cases, **worst}


def bound_ms(calls, backward_only=()) -> float:
    """The bytes' bound of ``calls`` (shapes, one per call) in bf16: the
    forward reads x and writes y, the backward reads x and dy and writes
    dx, each value once (10 bytes a value); ``backward_only`` shapes take
    the backward alone (6 bytes)."""
    values = sum(n * c * h * w for n, c, h, w in calls)
    values_b = sum(n * c * h * w for n, c, h, w in backward_only)
    return bound(10 * values + 6 * values_b, 0)["bound_ms"]


def time_calls(device, calls, backward_only=(), iters=5) -> dict:
    """Device time of the kernels and of ATen's native kernels over
    ``calls`` (forward, ReLU, backward each; ``backward_only`` shapes the
    backward alone, without a mask), bf16, in turns (kernels, ATen, ATen,
    kernels), each turn a profiler trace of ``iters`` passes."""
    inputs = {}
    for k, s in enumerate(sorted(set(calls) | set(backward_only))):
        x, dy, gamma, beta, rm, rv = _tensors(s, torch.bfloat16, device, k)
        y, mean, invstd = bn.batch_norm_train(x, gamma, beta, rm, rv,
                                              MOMENTUM, EPS, True)
        inputs[s] = (x, dy, gamma, beta, rm, rv, y, mean, invstd)
    aten = torch.ops.aten

    def kernels():
        for s in calls:
            x, dy, gamma, beta, rm, rv, _, _, _ = inputs[s]
            _, mean, invstd = bn.batch_norm_train(x, gamma, beta, rm, rv,
                                                  MOMENTUM, EPS, True)
            bn.batch_norm_backward(dy, x, mean, invstd, gamma, beta, True)
        for s in backward_only:
            x, dy, gamma, beta, _, _, _, mean, invstd = inputs[s]
            bn.batch_norm_backward(dy, x, mean, invstd, gamma, beta, False)

    def library():
        for s in calls:
            x, dy, gamma, beta, rm, rv, _, _, _ = inputs[s]
            y, mean, invstd = aten.native_batch_norm(x, gamma, beta, rm, rv,
                                                     True, MOMENTUM, EPS)
            y = aten.relu(y)
            g = aten.threshold_backward(dy, y, 0)
            aten.native_batch_norm_backward(g, x, gamma, rm, rv, mean,
                                            invstd, True, EPS,
                                            [True, True, True])
        for s in backward_only:
            x, dy, gamma, beta, rm, rv, _, mean, invstd = inputs[s]
            aten.native_batch_norm_backward(dy, x, gamma, rm, rv, mean,
                                            invstd, True, EPS,
                                            [True, True, True])

    k1, l1, l2, k2 = (device_ms(f, iters) for f in (kernels, library,
                                                    library, kernels))
    by_kernel = {}
    for e in device_events(kernels, iters):
        if e["cat"] == "kernel":
            name = re.search(r"bn_train_\w+|$", e["name"]).group() or "other"
            by_kernel[name] = by_kernel.get(name, 0.0) + e["dur"] / iters / 1e3
    lim = bound_ms(calls, backward_only)
    return {"calls": len(calls), "backward_only": len(backward_only),
            "ms": [k1, k2], "library_ms": [l1, l2], "bound_ms": lim,
            "share_of_bound": 100.0 * lim / ((k1 + k2) / 2),
            "by_kernel_ms": by_kernel}


def time_per_shape(device, iters=10) -> dict:
    """:func:`time_calls` on each distinct shape of the step sets, one
    call each."""
    shapes = sorted({s for d in STEP_SHAPES.values() for s in d})
    return {"x".join(map(str, s)): time_calls(device, [s], iters=iters)
            for s in shapes}


def time_step_sets(device) -> dict:
    """:func:`time_calls` on each train step's BatchNorm calls (HRNet's
    with its chains' backward), with their counts."""
    def expand(counts):
        return [s for s, n in counts.items() for _ in range(n)]
    return {"hourglass": time_calls(device, expand(STEP_SHAPES["hourglass"])),
            "w32": time_calls(device, expand(STEP_SHAPES["w32"]),
                              expand(W32_CHAIN_STEP))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_bn: needs a CUDA device")
    device = torch.device("cuda", 0)
    result = {"card": card_label(), "kind": torch.cuda.get_device_name(0)}
    print(result["card"], flush=True)
    _build.load_library()
    result["ptxas"] = ptxas_report("batch_norm.cu")
    for ln in result["ptxas"]:
        print(ln, flush=True)
    result["check"] = check_cases(device)
    print("check:", result["check"], flush=True)
    result["per_shape"] = time_per_shape(device)
    for name, r in result["per_shape"].items():
        print(f"{name}: {r}", flush=True)
    result["step_sets"] = time_step_sets(device)
    for name, r in result["step_sets"].items():
        print(f"{name}: {r}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
