"""Where the serve step's time goes, on one CUDA device.

    python3 -m fhpe_tpu_torch.tools.profile_serve [--cfg YAML] [--out PATH]

Serves a model (by default the FPD student,
``experiments/mpii/hourglass/hg4_128_student.yaml``; ``--cfg`` takes any
experiment file, e.g. HRNet-W32's) in bf16 with the flip test on, batch
32, random weights from a seed.
Comparisons run in one process and in turns (A, B, B, A, ...), because
the host's speed drifts within and between runs:

1. served images/s of ``predict_crops`` on a request of 256 crops against
   the step alone on a batch already on the device (host clock, each
   timing ends synchronised);
2. one forward in NCHW against channels_last: device time per forward
   (profiler kernel durations) and wall time per forward (host clock);
3. one request of 256 crops under the profiler: device busy time, idle
   share, device ops per chunk, and kernel time by group.

Writes one JSON object to ``--out`` and prints it.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..models import get_pose_net
from ..serve import Predictor
from ..utils.dtype import autocast
from ..utils.profiling import busy_ms, card_label, device_events, device_ms

REPO = Path(__file__).resolve().parents[2]
STUDENT = REPO / "experiments/mpii/hourglass/hg4_128_student.yaml"
CROPS = 256     # one request: 8 chunks of 32
TURNS = 3       # (A, B, B, A) rounds of the served-rate comparison

# kernel-name substrings -> group, first match wins
KERNEL_GROUPS = (
    ("decode_kernel", "decode kernel"),
    ("wgrad_", "conv wgrad kernel (P4)"),
    ("chain_", "branch chain kernel (P5)"),
    ("conv3x3_fwd", "conv3x3_fwd kernel (P1-P3)"),
    ("multi_tensor_apply", "optimizer"),
    ("reduce_kernel", "reductions"),
    ("batch_norm", "batchnorm"),
    ("nchwToNhwc", "nchw<->nhwc transposes"),
    ("nhwcToNchw", "nchw<->nhwc transposes"),
    ("copy_kernel", "casts (copy)"),
    ("clamp", "relu"),
    ("max_pool", "pool / upsample"),
    ("upsample", "pool / upsample"),
    ("Functor_add", "bias and residual adds"),
    ("conv", "convolutions"),
    ("xmma", "convolutions"),
    ("gemm", "convolutions"),
    ("cutlass", "convolutions"),
    ("nvjet", "convolutions"),    # GEMM kernels; the model has no matmul
)


def kernel_group(name: str) -> str:
    for key, group in KERNEL_GROUPS:
        if key in name:
            return group
    return "other"


def make_predictor(cfg_path: Path, seed: int) -> Predictor:
    cfg = load_config(str(cfg_path))
    cfg.defrost()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.SHIFT_HEATMAP = True
    cfg.TEST.POST_PROCESS = True
    cfg.freeze()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = get_pose_net(cfg)
    return Predictor(cfg, model, device="cuda:0")   # one replica


def request(p: Predictor, n: int, seed: int):
    rng = np.random.RandomState(seed)
    w, h = p.image_size
    return (rng.randint(0, 256, size=(n, h, w, 3)).astype(np.uint8),
            rng.uniform(100, 400, size=(n, 2)),
            rng.uniform(0.8, 2.0, size=(n, 2)))


def wall_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", default=str(STUDENT),
                    help="experiment YAML of the model to serve")
    ap.add_argument("--out", default=str(REPO / "build" /
                                         "profile_serve.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")

    cfg_path = Path(args.cfg).resolve()
    p = make_predictor(cfg_path, seed=0)
    p.warmup()
    crops, centers, scales = request(p, CROPS, seed=1)
    chunks = -(-CROPS // p.batch_size)
    b = p.batch_size
    dev_img = torch.from_numpy(crops[:b]).to(p.device)
    dev_inv = torch.zeros((b, 2, 3), dtype=torch.float32, device=p.device)
    batch = {"image": dev_img, "inv_trans": dev_inv}

    def serve():
        p.predict_crops(crops, centers, scales)

    def step_alone():
        for _ in range(chunks):
            p.step(p.model, batch)

    serve()
    step_alone()
    rates = {"predict_crops": [], "step_alone": []}
    for _ in range(TURNS):
        for name, fn in (("predict_crops", serve), ("step_alone", step_alone),
                         ("step_alone", step_alone),
                         ("predict_crops", serve)):
            n = chunks * b if name == "step_alone" else CROPS
            rates[name].append(n / wall_s(fn))

    # one forward, NCHW against channels_last
    x = torch.randn((b, 3, p.image_size[1], p.image_size[0]),
                    device=p.device)
    nchw = p.model
    nhwc = copy.deepcopy(p.model).to(memory_format=torch.channels_last)
    x_nhwc = x.contiguous(memory_format=torch.channels_last)
    forwards = {
        "nchw": lambda: nchw(x),
        "channels_last": lambda: nhwc(x_nhwc),
    }
    fwd = {k: {"device_ms": [], "wall_ms": []} for k in forwards}
    with torch.inference_mode(), autocast(p.dtype, p.device):
        for name in ("nchw", "channels_last", "channels_last", "nchw"):
            fn = forwards[name]
            fwd[name]["device_ms"].append(device_ms(fn, iters=10))
            fwd[name]["wall_ms"].append(
                1e3 * wall_s(lambda: [fn() for _ in range(10)]) / 10)

    # one request under the profiler
    walls = []
    events = device_events(lambda: walls.append(wall_s(serve)))
    window_ms = 1e3 * walls[0]
    kernels = [e for e in events if e["cat"] == "kernel"]
    by_group, unclassified = Counter(), Counter()
    for e in kernels:
        group = kernel_group(e["name"])
        by_group[group] += float(e["dur"]) / 1e3
        if group == "other":
            unclassified[e["name"][:120]] += float(e["dur"]) / 1e3
    busy = busy_ms(events)

    out = {
        "card": card_label(),
        "config": str(cfg_path.relative_to(REPO)),
        "batch": b, "crops": CROPS, "dtype": "bfloat16",
        "images_per_s": rates,
        "forward": fwd,
        "profiled_request": {
            "window_ms": window_ms,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / window_ms,
            "device_ops_per_chunk": len(events) / chunks,
            "kernel_ms_by_group": dict(by_group.most_common()),
            "other_kernels_ms": unclassified.most_common(8),
            "memcpy_ms": sum(float(e["dur"]) for e in events
                             if e["cat"] == "gpu_memcpy") / 1e3,
        },
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
