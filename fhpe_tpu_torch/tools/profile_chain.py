"""P5, the HRNet branch-chain kernels (P5e eval, P5t train), alone on one
CUDA device.

    python3 -m fhpe_tpu_torch.tools.profile_chain [--out PATH]

1. builds the kernels (``ops/_build.py``), prints ``nvidia-smi``'s name and
   power limit, ``-Xptxas -v``'s registers, shared memory and spills of
   ``branch_chain.cu``'s entries, and the count of tensor-core instructions
   (``HMMA`` / ``HGMMA``) in each entry's SASS (``cuobjdump -sass``, where
   the toolkit has it);
2. holds P5e and P5t against their plain versions on every W32 and W48
   chain shape at batch 32 and on ``EDGE_CASES``
   (``ops/branch_chain_cases.py``), bf16 and float32, TF32 off: two runs
   bit-equal, y and the batch statistics within the bars below;
3. times each entry in bf16 against the same chain run as unfused PyTorch
   modules (cuDNN convs, BatchNorm, ReLU, adds; timed, never used), in
   turns (kernel, modules, modules, kernel), each a profiler trace of
   several calls: on each of the eight shapes, with the plain version once
   beside it, and on one W48 -> W32 step's set of chain forwards (26 W48
   eval chains, 26 W32 train chains);
4. splits each entry's device time at ``TIMED`` by kernel (the convs by
   epilogue and prologue, the statistics merges, the block outputs);
5. times, on the host, what the wrapper adds per call: the bf16 plan
   computed afresh and looked up in its cache, and the wrapper's whole
   enqueue of a chain.

``chip_smoke.py`` calls the same functions.  Writes one JSON object to
``--out`` and prints it.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import time
from collections import Counter
from pathlib import Path

import torch

from ..ops import _build
from ..ops import branch_chain as bc
from ..ops.branch_chain_cases import (BLOCKS, BRANCH_CHAINS, EDGE_CASES,
                                      W32_SHAPES, W48_SHAPES, chain_input,
                                      chain_params)
from ..ops.conv3x3_fwd import bf16_plan
from ..utils.dtype import autocast
from ..utils.profiling import (card_label, device_events, device_ms,
                               ptxas_report, tensor_core_counts)
from .train_parity import tf32_off

# Card peaks for the bound (NVIDIA H100 SXM data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12    # tensor cores, bf16 in, float32 accumulate
TIMED = (32, 32, 64, 48)   # W32's branch 0 at batch 32, 4 blocks
# P5 against its plain version on the card, TF32 off.  In bf16 both round
# at four places per block and sum each conv in another order, so where an
# exact value lies near a rounding boundary the two round apart by one
# ulp, and that carries into the next convs: y is held to Y_TOL of max|y|
# (one bf16 ulp is 2^-8 to 2^-7 of it) and the mean |diff| to Y_MEAN_TOL
# of max|y|; the batch means to STATS_TOL of sqrt(var + eps), the
# variances to STATS_TOL of var + eps.  float32 differs only in the order
# of the sums.  Measured on an H100 over the 13 chains: bf16 max 1.09e-2,
# mean 5.9e-4, stats 1.75e-3 (the mma.sync mainloop; 1.09e-2, 5.2e-4 and
# 1.5e-3 on the earlier wmma core); float32 max 1.9e-6, mean 1.5e-7, stats
# 7.8e-7.
Y_TOL = {"bfloat16": 2.0 ** -5, "float32": 2e-5}
Y_MEAN_TOL = {"bfloat16": 1e-3, "float32": 2e-6}
STATS_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
ENTRIES = ("eval", "train")


def chain_tensors(shape, blocks, seed, device):
    """A chain input and parameters from ``branch_chain_cases``, float32."""
    b, c, h, w = shape
    p = chain_params(c, blocks, seed)
    x = torch.from_numpy(chain_input(b, c, h, w, seed + 1)).to(device)
    ws, gs, bs = (list(torch.from_numpy(p[k]).to(device).unbind(0))
                  for k in ("weights", "gammas", "betas"))
    return x, ws, gs, bs


def unfused_chain(x, ws, gs, bs, means, variances):
    """The same chain as PyTorch modules run one by one (cuDNN convs,
    BatchNorm, ReLU, adds): the yardstick P5 is timed against."""
    from ..models.common import BasicBlock
    from ..models.pose_hrnet import BranchChain
    c = x.shape[1]
    chain = BranchChain(*[BasicBlock(c, c) for _ in range(len(ws) // 2)])
    chain.fused = False
    convs = [cv for b in chain for cv in (b.conv1, b.conv2)]
    bns = [bn for b in chain for bn in (b.bn1, b.bn2)]
    with torch.no_grad():
        for i, (cv, bn) in enumerate(zip(convs, bns)):
            cv.weight.copy_(ws[i])
            bn.weight.copy_(gs[i])
            bn.bias.copy_(bs[i])
            bn.running_mean.copy_(means[i])
            bn.running_var.copy_(variances[i])
    return chain.to(x.device)


def chain_flop(shapes, blocks=BLOCKS) -> float:
    """Operations of chain calls on ``shapes``: 2 nb convs of 18 C^2 per
    pixel each."""
    return sum(2 * blocks * 18 * c * c * b * h * w for b, c, h, w in shapes)


def chain_bound(shapes, train: bool, blocks=BLOCKS) -> dict:
    """Least time for bf16 chain calls on ``shapes`` (one entry per call):
    2 nb convs of 18 C^2 operations per pixel at the bf16 peak, or the
    bytes: x read, the weights and BN parameters read, y written (train:
    every block output and every pre-BN conv output, which the kernel
    returns for the backward), whichever is larger."""
    nbytes = 0
    for b, c, h, w in shapes:
        act = 2 * b * c * h * w
        written = (3 * blocks if train else 1) * act
        nbytes += act + written + 2 * blocks * (2 * 9 * c * c + 4 * 2 * c)
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = chain_flop(shapes, blocks) / BF16_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _diff(got, ref):
    scale = max(ref.abs().max().item(), 1e-30)
    d = (got.float() - ref.float()).abs()
    return d.max().item() / scale, d.mean().item() / scale, d.max().item()


def check_cases(device) -> dict:
    """P5e and P5t against their plain versions on every W32/W48 chain
    shape at batch 32 and on ``EDGE_CASES``, bf16 and float32, TF32 off;
    raises on a case beyond its bars or not bit-equal run to run.  Returns
    the number of cases and, per (entry, dtype), the worst max|diff| and
    mean|diff| as shares of max|y|, the worst batch statistics (train) and
    the worst max|diff|."""
    cases = [(*s, BLOCKS) for s in W32_SHAPES + W48_SHAPES] + EDGE_CASES
    worst = {f"{e} {dt}": [0.0, 0.0, 0.0, 0.0] for e in ENTRIES
             for dt in Y_TOL}
    bad = []
    with tf32_off():
        for k, (b, c, h, w, nb) in enumerate(cases):
            x, ws, gs, bs = chain_tensors((b, c, h, w), nb, 40 + k, device)
            # running statistics that match the data: the batch statistics
            # of the float32 chain on this input
            ref32 = bc.branch_chain_train_plain(x, ws, gs, bs)
            means, variances = ref32.mean.unbind(0), ref32.var.unbind(0)
            for name, dt in (("bfloat16", torch.bfloat16),
                             ("float32", torch.float32)):
                xd, wd = x.to(dt), [t.to(dt) for t in ws]
                e1, e2 = (bc.branch_chain_eval(xd, wd, gs, bs, means,
                                               variances) for _ in range(2))
                ep = bc.branch_chain_eval_plain(xd, wd, gs, bs, means,
                                                variances)
                t1, t2 = (bc.branch_chain_train(xd, wd, gs, bs)
                          for _ in range(2))
                tp = bc.branch_chain_train_plain(xd, wd, gs, bs)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                sd = torch.sqrt(tp.var + bc.BN_EPS)
                st = max(((t1.mean - tp.mean).abs() / sd).max().item(),
                         ((t1.var - tp.var).abs() / sd.square()).max().item())
                same = (torch.equal(e1, e2) and torch.equal(t1.y, t2.y)
                        and torch.equal(t1.mean, t2.mean)
                        and torch.equal(t1.var, t2.var))
                for entry, (mx, mean, ab), stats in (
                        ("eval", _diff(e1, ep), 0.0),
                        ("train", _diff(t1.y, tp.y), st)):
                    acc = worst[f"{entry} {name}"]
                    acc[:] = [max(acc[0], mx), max(acc[1], mean),
                              max(acc[2], stats), max(acc[3], ab)]
                    if not (same and mx <= Y_TOL[name]
                            and mean <= Y_MEAN_TOL[name]
                            and stats <= STATS_TOL[name]):
                        bad.append((entry, name, (b, c, h, w, nb), mx, mean,
                                    stats, same))
    if bad:
        raise AssertionError(f"P5 beyond its bars or not bit-equal run to "
                             f"run: {bad[:6]}")
    return {"cases": len(cases), "worst": worst}


def _runs(device, shape, seed):
    """(kernel, plain, modules) callables of each entry at ``shape``, bf16
    (the modules under autocast, as the model runs them)."""
    x, ws, gs, bs = chain_tensors(shape, BLOCKS, seed, device)
    ref = bc.branch_chain_train_plain(x, ws, gs, bs)
    means, variances = ref.mean.unbind(0), ref.var.unbind(0)
    xd, wd = x.to(torch.bfloat16), [t.to(torch.bfloat16) for t in ws]
    mods = unfused_chain(x, ws, gs, bs, means, variances)

    def modules(train):
        def run():
            mods.train(train)
            with torch.no_grad(), autocast(torch.bfloat16, device):
                return mods(x)
        return run

    return {
        "eval": (lambda: bc.branch_chain_eval(xd, wd, gs, bs, means,
                                              variances),
                 lambda: bc.branch_chain_eval_plain(xd, wd, gs, bs, means,
                                                    variances),
                 modules(False)),
        "train": (lambda: bc.branch_chain_train(xd, wd, gs, bs),
                  lambda: bc.branch_chain_train_plain(xd, wd, gs, bs),
                  modules(True))}


def time_shape(device, shape, seed=60, iters=10) -> dict:
    """Device time per call of P5e and P5t at ``shape`` x ``BLOCKS``
    blocks, bf16, in turns with the unfused modules (kernel, modules,
    modules, kernel), then the plain version once; per entry with its bound
    and TFLOP/s."""
    out = {}
    for entry, (kernel, plain, modules) in _runs(device, shape,
                                                 seed).items():
        k1, m1, m2, k2 = (device_ms(f, iters) for f in (kernel, modules,
                                                        modules, kernel))
        out[entry] = {"ms": [k1, k2], "library_ms": [m1, m2],
                      "plain_ms": device_ms(plain, iters),
                      **chain_bound([shape], entry == "train"),
                      "tflops": chain_flop([shape]) / ((k1 + k2) / 2) / 1e9}
    return out


def time_per_shape(device) -> dict:
    """:func:`time_shape` on each of the eight W32/W48 shapes."""
    return {"x".join(map(str, s)): time_shape(device, s, 60 + k)
            for k, s in enumerate(W32_SHAPES + W48_SHAPES)}


def step_chains():
    """One W48 -> W32 FPD step's chain forwards: the teacher's 26 W48
    chains in eval mode, then the student's 26 W32 chains in train mode
    (shapes at batch 32)."""
    return ([("eval", s) for s, n in zip(W48_SHAPES, BRANCH_CHAINS)
             for _ in range(n)]
            + [("train", s) for s, n in zip(W32_SHAPES, BRANCH_CHAINS)
               for _ in range(n)])


def time_step_set(device, iters=3) -> dict:
    """Device time of one step's 52 chain forwards (:func:`step_chains`) on
    P5 against the same chains as unfused modules, in turns (P5, modules,
    modules, P5), each a profiler trace of ``iters`` passes; also the W48
    eval and W32 train halves on P5 alone."""
    runs = {s: _runs(device, s, 80 + k)
            for k, s in enumerate(W32_SHAPES + W48_SHAPES)}
    calls = step_chains()

    def on(which, entries=ENTRIES):
        def fn():
            for entry, s in calls:
                if entry in entries:
                    runs[s][entry][which]()
        return fn

    p1, m1, m2, p2 = (device_ms(on(i), iters) for i in (0, 2, 2, 0))
    halves = {e: device_ms(on(0, (e,)), iters) for e in ENTRIES}
    shapes = [s for _, s in calls]
    bound = sum(chain_bound([s], e == "train")["bound_ms"]
                for e, s in calls)
    return {"calls": len(calls), "gflop": chain_flop(shapes) / 1e9,
            "ms": [p1, p2], "library_ms": [m1, m2],
            "w48_eval_ms": halves["eval"], "w32_train_ms": halves["train"],
            "bound_ms": bound,
            "tflops": chain_flop(shapes) / ((p1 + p2) / 2) / 1e9}


def time_parts(device, shape=TIMED, iters=10) -> dict:
    """Device ms per call of each entry at ``shape``, bf16, by kernel
    (the profiler's name without its arguments), from one trace of
    ``iters`` calls."""
    out = {}
    for entry, (kernel, _, _) in _runs(device, shape, 70).items():
        parts = Counter()
        for e in device_events(kernel, iters):
            if e["cat"] == "kernel":
                name = e["name"].replace("(anonymous namespace)::", "")
                name = re.sub(r"^void |\(.*", "", name)
                parts[name] += float(e["dur"]) / iters / 1e3
        out[entry] = dict(parts.most_common())
    return out


def time_host(device, passes=5, calls=26) -> dict:
    """Host µs per call at ``TIMED``, median of ``passes`` passes of
    ``calls`` calls: the bf16 plan computed afresh (``bf16_plan`` past its
    cache) and looked up, and each wrapper's whole enqueue (plan,
    allocation, launches), the device drained before each pass."""
    kernels = {e: r[0] for e, r in _runs(device, TIMED, 90).items()}
    b, _, h, w = TIMED

    def per_call(f):
        times = []
        for _ in range(passes):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(calls):
                f()
            times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize(device)
        return statistics.median(times)

    return {"plan_us": per_call(lambda: bf16_plan.__wrapped__(b, h, w)),
            "cached_plan_us": per_call(lambda: bf16_plan(b, h, w)),
            **{f"{e}_wrapper_us": per_call(f) for e, f in kernels.items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_chain: needs a CUDA device")
    device = torch.device("cuda", 0)
    result = {"card": card_label(), "kind": torch.cuda.get_device_name(0)}
    print(result["card"], flush=True)
    _build.load_library()
    result["ptxas"] = ptxas_report("branch_chain.cu")
    result["tensor_core_instructions"] = tensor_core_counts("chain_")
    for ln in result["ptxas"]:
        print(ln, flush=True)
    print("SASS (HMMA, HGMMA):", result["tensor_core_instructions"],
          flush=True)
    result["check"] = check_cases(device)
    print("check:", result["check"], flush=True)
    result["per_shape"] = time_per_shape(device)
    for name, r in result["per_shape"].items():
        print(f"{name}: {r}", flush=True)
    result["step_set"] = time_step_set(device)
    print("W48 -> W32 step's 52 chains:", result["step_set"], flush=True)
    result["by_kernel"] = time_parts(device)
    print(f"{TIMED} by kernel, ms per call:", result["by_kernel"],
          flush=True)
    result["host_us_per_call"] = time_host(device)
    print("host µs per call:", result["host_us_per_call"], flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
