#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fhpe_tpu_torch``) on one GPU.

Drives the port's serving path once, end to end, through the entry points
a user calls (``Predictor.warmup`` / ``Predictor.predict_crops``), at the
full width of the FPD hourglass student (4 stacks x 128 features, MPII
256x256, 16 joints) and of the teacher (8 x 256), with random weights from
a seed.  Phases, one line each; any failure raises and exits non-zero:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles ``fhpe_tpu_torch/ops/csrc/*.cu`` with nvcc;
3. decode kernel against its plain PyTorch version on planted edge cases
   (bit-equal), then the device time of both from a profiler trace;
4. student serve in bf16: requests of 1, 32 and 45 crops, shape/finite
   checks, kernel launch count, kernel vs plain on one chunk's heatmaps,
   the bf16 dtype flow of every conv/BN/block, warm images/s;
5. float32 parity (TF32 off): the student on the card against the same
   port on the CPU;
6. teacher serve: one request of 32 crops with the checks of phase 4.

Then one JSON line with the kernels, and last the ``{"ok": true, ...}``
line.  Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
STUDENT_YAML = REPO / "experiments/mpii/hourglass/hg4_128_student.yaml"
TEACHER_YAML = REPO / "experiments/mpii/hourglass/hg8_256x256_teacher.yaml"
KERNEL_SOURCE = "fhpe_tpu_torch/ops/csrc/decode.cu"
KERNEL_REPLACES = "fhpe_tpu/ops/decode_pallas.py:24"
DECODE_SHAPES = [(32, 16, 64, 64), (32, 17, 64, 48), (3, 5, 7, 9),
                 (1, 1, 1, 1)]
TIMED_SHAPE = (32, 16, 64, 64)
# float32 parity of the student, card (cuDNN, TF32 off) against CPU: the
# convolutions sum in another order, which moves float32 heatmaps by
# about 1e-6 relative per layer over ~100 layers.
PARITY_HM_ATOL = 1e-3
# Joints whose decode decisions all have a margin above 2 x PARITY_HM_ATOL
# take the same argmax and offsets on both sides, so their preds differ
# only by the float32 affine: within PARITY_PREDS_ATOL px.
PARITY_PREDS_ATOL = 1e-3


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def serve_cfg(yaml_path, dtype="bfloat16"):
    from fhpe_tpu_torch.config import load_config
    cfg = load_config(str(yaml_path))
    cfg.defrost()
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.SHIFT_HEATMAP = True
    cfg.TEST.POST_PROCESS = True
    cfg.freeze()
    return cfg


def seeded_model(cfg, seed: int):
    """torch-default-initialised weights from a fixed seed."""
    import torch
    from fhpe_tpu_torch.models import get_pose_net
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return get_pose_net(cfg)


def make_requests(cfg, n: int, seed: int):
    rng = np.random.RandomState(seed)
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    crops = rng.randint(0, 256, size=(n, h, w, 3)).astype(np.uint8)
    centers = rng.uniform(100, 400, size=(n, 2))
    scales = rng.uniform(0.8, 2.0, size=(n, 2))
    return crops, centers, scales


def phase_kernel_vs_plain(device) -> dict:
    """Kernel against plain on planted cases, bit-equal; then timings."""
    import torch
    from fhpe_tpu_torch.ops.decode import decode_argmax, decode_argmax_plain
    from fhpe_tpu_torch.ops.decode_cases import planted_heatmaps
    from fhpe_tpu_torch.utils.profiling import device_ms

    cases = []
    for shape in DECODE_SHAPES:
        hm = torch.from_numpy(planted_heatmaps(*shape, seed=11)).to(device)
        cases.append((str(shape), hm))
    # a contiguous tensor whose rows are not 16-byte aligned (scalar path)
    n = int(np.prod(TIMED_SHAPE))
    buf = torch.empty(n + 1, dtype=torch.float32, device=device)
    buf[1:] = torch.from_numpy(planted_heatmaps(*TIMED_SHAPE, seed=12)
                               ).reshape(-1).to(device)
    cases.append((f"{TIMED_SHAPE} unaligned", buf[1:].view(TIMED_SHAPE)))

    max_err = 0.0
    for name, hm in cases:
        for post in (True, False):
            kc, kv = decode_argmax(hm, post)
            pc, pv = decode_argmax_plain(hm, post)
            if device.type == "cuda":
                torch.cuda.synchronize()
            err = max((kc - pc).abs().max().item(),
                      (kv - pv).abs().max().item())
            max_err = max(max_err, err)
            if not (torch.equal(kc, pc) and torch.equal(kv, pv)):
                raise AssertionError(f"decode kernel != plain on {name} "
                                     f"post_process={post}: max err {err}")
    log("kernel", f"decode kernel == plain (bit-equal) on {len(cases)} "
        f"planted cases x post_process on/off")

    timing = {"ms": None, "plain_ms": None}
    if device.type == "cuda":
        hm = torch.from_numpy(planted_heatmaps(*TIMED_SHAPE, seed=13)
                              ).to(device)
        def kernel():
            return decode_argmax(hm, True)

        def plain():
            return decode_argmax_plain(hm, True)

        # in turns: plain, kernel, kernel, plain
        dp1, dk1, dk2, dp2 = (device_ms(f) for f in (plain, kernel, kernel,
                                                     plain))
        timing = {"ms": (dk1 + dk2) / 2, "plain_ms": (dp1 + dp2) / 2}
        log("kernel", f"decode {TIMED_SHAPE} float32, warm L2: device time "
            f"per call (profiler) kernel {dk1:.4f}/{dk2:.4f} ms, plain "
            f"{dp1:.4f}/{dp2:.4f} ms")
    return {"max_abs_err": max_err, **timing}


def check_outputs(phase, preds, maxvals, n, num_joints):
    if preds.shape != (n, num_joints, 2) or maxvals.shape != (n, num_joints):
        raise AssertionError(f"{phase}: shapes {preds.shape} "
                             f"{maxvals.shape}, expected ({n}, "
                             f"{num_joints}, 2) and ({n}, {num_joints})")
    if not (np.isfinite(preds).all() and np.isfinite(maxvals).all()):
        raise AssertionError(f"{phase}: non-finite outputs")


def check_kernel_path_on_chunk(phase, p, crops, centers, scales):
    """One chunk's merged heatmaps: kernel path == plain path preds."""
    import torch
    from fhpe_tpu_torch.ops.decode import (decode_heatmaps,
                                           make_inverse_transforms)
    b = p.batch_size
    hm = p.merged_heatmaps(torch.from_numpy(crops[:b]).to(p.device))
    inv = torch.from_numpy(make_inverse_transforms(
        centers[:b], scales[:b], p.heatmap_size))
    kp, kv = decode_heatmaps(hm, inv.to(p.device), p.post_process)
    pp, pv = decode_heatmaps(hm.cpu(), inv, p.post_process)
    if not (torch.equal(kp.cpu(), pp) and torch.equal(kv.cpu(), pv)):
        raise AssertionError(f"{phase}: kernel-path preds != plain-path "
                             f"preds on one chunk's merged heatmaps")
    log(phase, f"kernel path == plain path on one chunk of {b} "
        f"(merged heatmaps {tuple(hm.shape)})")


def check_bf16_flow(phase, p, crops):
    """The forward on the card keeps fhpe_tpu's bf16 flow (CUDA autocast
    lists some ops as float32, the CPU tests cannot see that)."""
    import torch
    from fhpe_tpu_torch.models.hourglass import bf16_flow_violations
    from fhpe_tpu_torch.ops.preprocess import normalize_images
    if p.dtype != torch.bfloat16:
        return
    x = normalize_images(torch.from_numpy(crops).to(p.device))
    checked, bad = bf16_flow_violations(p.model, x)
    if bad:
        raise AssertionError(f"{phase}: bf16 flow broken at {len(bad)} of "
                             f"{checked} modules, first {bad[:3]}")
    log(phase, f"bf16 flow as fhpe_tpu's at all {checked} modules checked "
        f"(convs, BNs, blocks: bf16 in and out; heatmaps float32)")


def phase_serve(phase, cfg, device, requests, seed, label="") -> int:
    """Serve ``requests`` (crop counts); returns the kernel launches."""
    from fhpe_tpu_torch.ops import decode
    from fhpe_tpu_torch.serve import Predictor

    p = Predictor(cfg, seeded_model(cfg, seed), device=device)
    t0 = time.perf_counter()
    p.warmup()
    log(phase, f"warmup {time.perf_counter() - t0:.2f} s "
        f"(batch {p.batch_size}, {cfg.TPU.COMPUTE_DTYPE})")

    num_joints = int(cfg.MODEL.NUM_JOINTS)
    data = [make_requests(cfg, n, seed + 1 + i)
            for i, n in enumerate(requests)]
    chunks = sum(-(-n // p.batch_size) for n in requests)
    decode.decode_kernel_launches = 0
    outs = [p.predict_crops(*d) for d in data]
    launches = decode.decode_kernel_launches
    for n, (preds, maxvals) in zip(requests, outs):
        check_outputs(phase, preds, maxvals, n, num_joints)
    expect = chunks if device.type == "cuda" else 0
    if launches != expect:
        raise AssertionError(f"{phase}: {launches} decode kernel launches "
                             f"for {chunks} chunks")
    log(phase, f"requests {requests}: shapes and finite ok, "
        f"decode_kernel_launches {launches} == chunks {chunks}")
    check_kernel_path_on_chunk(phase, p, *max(data, key=lambda d: len(d[0])))
    check_bf16_flow(phase, p, data[0][0])

    if label:
        crops, centers, scales = make_requests(cfg, 8 * p.batch_size,
                                               seed + 99)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            p.predict_crops(crops, centers, scales)
            rates.append(len(crops) / (time.perf_counter() - t0))
        log(phase, f"warm predict_crops {sorted(rates)[1]:.1f} images/s "
            f"(median of 3 x {len(crops)} crops, flip test on, "
            f"{cfg.TPU.COMPUTE_DTYPE}, batch {p.batch_size}) on {label}")
    return launches


def phase_f32_parity(cfg, device, seed) -> None:
    """Student float32 on the card (TF32 off) against the port on CPU."""
    import torch
    from fhpe_tpu_torch.ops.decode_cases import decision_margin
    from fhpe_tpu_torch.serve import Predictor

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = seeded_model(cfg, seed)
        crops, centers, scales = make_requests(cfg, 2, seed + 7)
        gpu = Predictor(cfg, model, batch_size=2, device=device)
        cpu = Predictor(cfg, seeded_model(cfg, seed), batch_size=2,
                        device="cpu")
        hm_g = gpu.merged_heatmaps(torch.from_numpy(crops).to(device)).cpu()
        hm_c = cpu.merged_heatmaps(torch.from_numpy(crops))
        hm_err = (hm_g - hm_c).abs().max().item()
        if not hm_err <= PARITY_HM_ATOL:
            raise AssertionError(f"f32 parity: heatmaps differ by {hm_err} "
                                 f"> {PARITY_HM_ATOL}")
        preds_g, vals_g = gpu.predict_crops(crops, centers, scales)
        preds_c, vals_c = cpu.predict_crops(crops, centers, scales)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev

    robust = decision_margin(hm_c.numpy()) > 2 * PARITY_HM_ATOL
    mismatch = (np.abs(preds_g - preds_c) > PARITY_PREDS_ATOL).any(-1) \
        & robust
    if mismatch.any():
        raise AssertionError(f"f32 parity: {int(mismatch.sum())} robust "
                             f"joints decode differently")
    val_err = np.abs(vals_g - vals_c).max()
    if not val_err <= PARITY_HM_ATOL:
        raise AssertionError(f"f32 parity: maxvals differ by {val_err}")
    log("f32-parity", f"card vs CPU, TF32 off: heatmaps max|diff| "
        f"{hm_err:.3g} (tol {PARITY_HM_ATOL}, max|hm| "
        f"{hm_c.abs().max().item():.3g}); preds within "
        f"{PARITY_PREDS_ATOL} px on {int(robust.sum())}/{robust.size} "
        f"joints with decode margin > {2 * PARITY_HM_ATOL} (max|pred diff| "
        f"over all {np.abs(preds_g - preds_c).max():.3g} px); maxvals "
        f"max|diff| {val_err:.3g}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from fhpe_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    label = card_label()
    log("device", f"{label} ({torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log("build", f"{lib_path.relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.2f} s")

    kernel = phase_kernel_vs_plain(device)

    student = serve_cfg(STUDENT_YAML)
    launches = phase_serve("student", student, device, [1, 32, 45], seed=0,
                           label=label)
    phase_f32_parity(serve_cfg(STUDENT_YAML, "float32"), device, seed=0)
    launches += phase_serve("teacher", serve_cfg(TEACHER_YAML), device, [32],
                            seed=100)

    print(json.dumps({"kernels": [{
        "name": "decode_heatmaps", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
