"""How far apart one float32 FPD train step lands on two backends.

    python3 -m fhpe_tpu_torch.tools.train_parity [--device cuda|cpu]
        [--stacks 4 --features 128 --image-size 256 --batch 2]
        [--teacher-stacks 8 --teacher-features 256]
    python3 -m fhpe_tpu_torch.tools.train_parity --pair hrnet
        [--width 32 --teacher-width 48 --image-size 256 --blocks 4]

Runs one FPD step (``make_fpd_train_step``'s eager body, Adam, TF32
off) from the same seeded weights and batch several ways: on the CPU in
float64 (the reference) and float32, and with ``--device cuda`` on the
card in float32 with the port's kernels and with one of them swapped for
PyTorch's own: for the hourglass pair cuDNN's filter gradient in P4's
place, for HRNet every branch chain unrouted from P5 (its blocks run as
modules).  For each pair it prints how far the losses, the BN running
statistics, Adam's moments and the updated parameters are apart.  The
defaults are the FPD pairs at full width: the hourglass (MPII) and
HRNet-W32 by W48 (COCO; ``--image-size`` is the height, the width
three quarters of it).  ``chip_smoke.py`` uses the same helpers.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from ..config import load_config
from ..data.coco_synthetic import synthetic_train_batch
from ..models import common, get_pose_net
from ..models.pose_hrnet import BranchChain
from ..train import (create_train_state, make_batch_preprocessor,
                     make_fpd_train_step, make_train_step)

REPO = Path(__file__).resolve().parents[2]
STUDENT_YAML = REPO / "experiments/fpd_mpii/hourglass/hg4_128_fpd_student.yaml"
TEACHER_YAML = REPO / "experiments/mpii/hourglass/hg8_256x256_teacher.yaml"
HRNET_STUDENT_YAML = REPO / "experiments/fpd_coco/hrnet/w32_fpd_student.yaml"
HRNET_TEACHER_YAML = REPO / "experiments/coco/hrnet/w48_256x192_teacher.yaml"
RN50_YAML = REPO / "experiments/coco/resnet/res50_256x192_d256x3_adam_lr1e-3.yaml"


def fpd_cfgs(dtype="bfloat16", stacks=None, features=None, image_size=None,
             teacher_stacks=None, teacher_features=None):
    """The FPD student and teacher configs, ``DEAD_BIAS_SKIP`` on as
    ``bench.py::bench_fpd_hg`` trains; optionally cut in depth, width
    and image size."""
    def load(path, extra, s, f):
        opts = ["TPU.COMPUTE_DTYPE", dtype, *extra]
        if s:
            opts += ["MODEL.EXTRA.NUM_STACKS", str(s)]
        if f:
            opts += ["MODEL.EXTRA.NUM_FEATURES", str(f)]
        if image_size:
            opts += ["MODEL.IMAGE_SIZE", f"[{image_size},{image_size}]",
                     "MODEL.HEATMAP_SIZE",
                     f"[{image_size // 4},{image_size // 4}]"]
        return load_config(str(path), opts)
    return (load(STUDENT_YAML, ["TPU.DEAD_BIAS_SKIP", "True"], stacks,
                 features),
            load(TEACHER_YAML, [], teacher_stacks, teacher_features))


def hrnet_fpd_cfgs(dtype="bfloat16", width=None, teacher_width=None,
                   image_size=None, blocks=None, modules=None):
    """The COCO FPD pair (student W32, ``KD.ALPHA`` 0.5; teacher W48),
    optionally cut: base ``width``, image height ``image_size`` (width
    three quarters of it), ``blocks`` per branch and ``modules`` per stage
    at most."""
    def load(path, w):
        opts = ["TPU.COMPUTE_DTYPE", dtype]
        if w:
            opts += [o for s in (2, 3, 4) for o in (
                f"MODEL.EXTRA.STAGE{s}.NUM_CHANNELS",
                str([w * 2 ** i for i in range(s)]))]
        if image_size:
            h, iw = image_size, image_size * 3 // 4
            opts += ["MODEL.IMAGE_SIZE", f"[{iw},{h}]",
                     "MODEL.HEATMAP_SIZE", f"[{iw // 4},{h // 4}]"]
        for s in (2, 3, 4):
            if blocks:
                opts += [f"MODEL.EXTRA.STAGE{s}.NUM_BLOCKS",
                         str([blocks] * s)]
            if modules:
                opts += [f"MODEL.EXTRA.STAGE{s}.NUM_MODULES",
                         str(min(modules, (1, 4, 3)[s - 2]))]
        return load_config(str(path), opts)
    return (load(HRNET_STUDENT_YAML, width),
            load(HRNET_TEACHER_YAML, teacher_width))


def train_batch(cfg, n, seed, device):
    """A DEVICE_PREPROCESS batch: uint8 crops, joints in crop pixels (a
    few off the crop), joints_vis; for COCO configs
    ``data/coco_synthetic.py::synthetic_train_batch``."""
    if cfg.DATASET.DATASET == "coco":
        batch = synthetic_train_batch(
            n, seed, tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE),
            int(cfg.MODEL.NUM_JOINTS))
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    rng = np.random.RandomState(seed)
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    j = int(cfg.MODEL.NUM_JOINTS)
    batch = {"image": rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
             "joints": np.stack([rng.uniform(-8, w + 8, (n, j)),
                                 rng.uniform(-8, h + 8, (n, j))],
                                -1).astype(np.float32),
             "joints_vis": (rng.uniform(size=(n, j)) > 0.1
                            ).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def pair_weights(scfg, tcfg):
    """Seeded student and teacher on the CPU: torch's default init from
    seeds 0 and 100 for the hourglass; for HRNet He-scale weights with BN
    statistics from one batch (``models/common.py::he_scale_weights``),
    since the reference init gives heatmaps of ~0."""
    if scfg.MODEL.NAME == "pose_hrnet":
        models = []
        for cfg, seed in ((scfg, 0), (tcfg, 100)):
            model = get_pose_net(cfg)
            w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
            common.he_scale_weights(model, seed, (h, w))
            models.append(model)
        return tuple(models)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        student = get_pose_net(scfg)
        torch.manual_seed(100)
        teacher = get_pose_net(tcfg)
    return student, teacher


def cudnn_wgrad(x, dy, weight):
    """PyTorch's own filter gradient (cuDNN): the yardstick P4 is held
    and timed against, never called on the port's path."""
    return torch.ops.aten.convolution_backward(
        dy, x, weight, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [False, True, False])[1]


def cudnn_in_p4s_place(x, dy):
    c = x.shape[1]
    return cudnn_wgrad(x, dy, x.new_zeros((c, c, 3, 3))).float()


@contextlib.contextmanager
def tf32_off():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev


def one_fpd_step(scfg, tcfg, student, teacher, batch, device, wgrad=None,
                 fused=True):
    """One FPD step on copies of ``student`` and ``teacher`` (CPU modules)
    on ``device``, in the configs' compute dtype; ``wgrad`` replaces P4;
    ``fused=False`` unroutes every HRNet branch chain from P5.  Returns
    (state, {loss, pose_loss, kd_loss} as floats)."""
    device = torch.device(device)
    state = create_train_state(scfg, copy.deepcopy(student), device=device)
    dtype = next(state.model.parameters()).dtype
    teacher = copy.deepcopy(teacher).to(device, dtype)
    for m in (*state.model.modules(), *teacher.modules()):
        if isinstance(m, BranchChain):
            m.fused = m.fused and fused
    step = make_fpd_train_step(scfg, teacher, tcfg,
                               prepare=make_batch_preprocessor(scfg))
    with (mock.patch.object(common, "conv3x3_wgrad", wgrad) if wgrad
          else contextlib.nullcontext()):
        state, metrics = step.eager(state, {k: v.to(device)
                                            for k, v in batch.items()})
    return state, {k: metrics[k].item()
                   for k in ("loss", "pose_loss", "kd_loss")}


def rn50_cfg(dtype="bfloat16"):
    """PoseResNet-50 on COCO 256x192 (``res50_256x192_d256x3_adam_lr1e-3
    .yaml``: Adam lr 1e-3, a plain train step) in ``dtype``."""
    return load_config(str(RN50_YAML), ["TPU.COMPUTE_DTYPE", dtype])


def one_train_step(cfg, model, batch, device, fwd_kernel=True):
    """One plain train step (``make_train_step``) on a copy of ``model`` (a
    CPU module) on ``device``, in the config's compute dtype;
    ``fwd_kernel=False`` sends every 3x3 conv routed to the conv3x3_fwd
    kernel to cuDNN instead.  Returns (state, {"loss": float})."""
    device = torch.device(device)
    state = create_train_state(cfg, copy.deepcopy(model), device=device)
    for m in common.fwd_kernel_convs(state.model):
        m.fwd_kernel = fwd_kernel
    step = make_train_step(cfg, prepare=make_batch_preprocessor(cfg))
    state, metrics = step.eager(state, {k: v.to(device)
                                        for k, v in batch.items()})
    return state, {"loss": metrics["loss"].item()}


def step_diff(a, b):
    """How far one-step run ``a`` is from ``b`` (the reference), each a
    ``(state, losses)``: the largest relative loss difference, BN running
    stats against each tensor's max, ``{moment: (relative L2 over all
    parameters, worst tensor against its max)}``, and of the parameters
    with a live gradient (|mu| >= 1e-3 of its tensor's max) how many
    moved apart by more than 1% of lr, and how many there are."""
    (sa, la), (sb, lb) = a, b
    loss = max(abs(la[k] - lb[k]) / abs(lb[k]) for k in lb)
    sd_a, sd_b = sa.model.state_dict(), sb.model.state_dict()
    stats = max(((sd_a[k].cpu().double() - v.cpu().double()).abs().max()
                 / v.abs().max()).item()
                for k, v in sd_b.items() if "running" in k)
    oa = sa.optimizer.state_dict()["state"]
    ob = sb.optimizer.state_dict()["state"]
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        ref = [ob[i][key].cpu().double() for i in ob]
        diffs = [oa[i][key].cpu().double() - r for i, r in zip(ob, ref)]
        moments[key] = (
            (sum(d.square().sum() for d in diffs).sqrt()
             / sum(r.square().sum() for r in ref).sqrt()).item(),
            max((d.abs().max() / r.abs().max()).item()
                for d, r in zip(diffs, ref)))
    lr = float(sb.optimizer.param_groups[0]["lr"])
    params_a = dict(sa.model.named_parameters())
    live = off = 0
    for i, (name, p) in enumerate(sb.model.named_parameters()):
        mu = ob[i]["exp_avg"].cpu().abs()
        ok = mu >= 1e-3 * mu.max()
        live += int(ok.sum())
        off += int(((params_a[name].detach().cpu().double()
                     - p.detach().cpu().double()).abs()[ok]
                    > 0.01 * lr).sum())
    return loss, stats, moments, off, live


def describe(loss, stats, moments, off, live) -> str:
    return (f"losses within {loss:.3g} (relative), BN running stats within "
            f"{stats:.3g} of each tensor's max, Adam moments relative L2 "
            + ", ".join(f"{k} {v[0]:.3g} (worst tensor {v[1]:.3g})"
                        for k, v in moments.items())
            + f"; {off} of {live} live parameters off by > 1% of lr")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--pair", default="hourglass",
                    choices=("hourglass", "hrnet"))
    ap.add_argument("--stacks", type=int)
    ap.add_argument("--features", type=int)
    ap.add_argument("--teacher-stacks", type=int)
    ap.add_argument("--teacher-features", type=int)
    ap.add_argument("--width", type=int)
    ap.add_argument("--teacher-width", type=int)
    ap.add_argument("--blocks", type=int)
    ap.add_argument("--modules", type=int)
    ap.add_argument("--image-size", type=int)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_parity: --device cuda needs a GPU")

    if args.pair == "hrnet":
        def cfgs(dtype):
            return hrnet_fpd_cfgs(dtype, args.width, args.teacher_width,
                                  args.image_size, args.blocks, args.modules)
        swap, swapped = dict(fused=False), "card float32, P5 unrouted"
    else:
        def cfgs(dtype):
            return fpd_cfgs(dtype, args.stacks, args.features,
                            args.image_size, args.teacher_stacks,
                            args.teacher_features)
        swap = dict(wgrad=cudnn_in_p4s_place)
        swapped = "card float32, cuDNN wgrad"
    runs = {}
    for dtype in ("float64", "float32"):
        scfg, tcfg = cfgs(dtype)
        student, teacher = pair_weights(scfg, tcfg)
        batch = train_batch(scfg, args.batch, seed=9, device="cpu")
        with tf32_off():
            runs[f"cpu {dtype}"] = one_fpd_step(scfg, tcfg, student,
                                                teacher, batch, "cpu")
            if dtype == "float32" and args.device == "cuda":
                runs["card float32"] = one_fpd_step(
                    scfg, tcfg, student, teacher, batch, "cuda")
                runs[swapped] = one_fpd_step(scfg, tcfg, student, teacher,
                                             batch, "cuda", **swap)
    if args.device == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    pairs = [(a, "cpu float64") for a in runs if a != "cpu float64"]
    if args.device == "cuda":
        pairs += [("card float32", "cpu float32"), ("card float32", swapped)]
    for a, b in pairs:
        print(f"{a} vs {b}: {describe(*step_diff(runs[a], runs[b]))}",
              flush=True)


if __name__ == "__main__":
    main()
