"""Shared building blocks for the pose backbones (NCHW, PyTorch).

Counterpart of ``fhpe_tpu/models/common.py`` and of the residual blocks
of ``fhpe_tpu/models/pose_hrnet.py``.  ``nn.BatchNorm2d`` already has the
semantics ``fhpe_tpu``'s ``_TorchBatchNorm`` rebuilds by hand (biased
variance to normalize, Bessel-corrected running variance, momentum 0.1,
eps 1e-5), and ``nn.Conv2d``'s default initialization is the one
``fhpe_tpu``'s ``torch_conv_kernel_init`` reproduces.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batch_norm import BatchNormFn
from ..ops.conv3x3_fwd import conv3x3_fwd
from ..ops.conv_wgrad import conv3x3_wgrad
from ..utils.dtype import autocast

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class _Conv3x3WgradFn(torch.autograd.Function):
    """3x3 stride-1 pad-1 conv whose filter gradient is the P4 port
    (``ops/conv_wgrad.py``): forward by cuDNN, or by the conv3x3_fwd
    kernel (``ops/conv3x3_fwd.py``) when ``fwd_kernel``; input gradient by
    cuDNN, bias gradient a sum.  Takes the tensors in the dtype the conv
    computes in and returns each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, fwd_kernel):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        if fwd_kernel:
            return conv3x3_fwd(x, weight, bias)
        with torch.autocast(x.device.type, enabled=False):
            return F.conv2d(x, weight, bias, 1, 1)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        with torch.autocast(x.device.type, enabled=False):
            if ctx.needs_input_grad[0]:
                dx = torch.ops.aten.convolution_backward(
                    dy, x, weight, None, [1, 1], [1, 1], [1, 1], False,
                    [0, 0], 1, [True, False, False])[0]
            if ctx.needs_input_grad[1]:
                dw = conv3x3_wgrad(x.contiguous(), dy).to(weight.dtype)
            if ctx.has_bias and ctx.needs_input_grad[2]:
                db = dy.sum((0, 2, 3))
        return dx, dw, db, None


class Conv3x3(nn.Conv2d):
    """``nn.Conv2d(c, c, 3, padding=1)`` whose training backward takes the
    filter gradient from the P4 port (``ops/conv_wgrad.py``).

    With ``fwd_kernel`` (bias-free only) its forward is the conv3x3_fwd
    kernel (``ops/conv3x3_fwd.py``), with grad on and off; else, under
    ``no_grad`` / ``inference_mode``, it is the plain conv.  Otherwise it
    hands the Function the copies of x, weight and bias that autocast
    would hand ``F.conv2d`` (bf16 under bf16 autocast), as ``fhpe_tpu``'s
    flax ``Conv`` casts its float32 kernel inside the forward: the weight
    gradient is then rounded to the copy's dtype and the cast's backward
    lifts it to float32, as both frameworks do.  The kernel route casts
    the same way by hand (autocast never reaches a custom kernel) and
    hands the kernel contiguous NCHW copies.  Same parameters and
    ``state_dict`` keys as ``nn.Conv2d``.
    """

    def __init__(self, *args, fwd_kernel: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        if fwd_kernel and self.bias is not None:
            raise ValueError("the conv3x3_fwd kernel takes no bias")
        self.fwd_kernel = fwd_kernel

    def forward(self, x):
        if not (self.fwd_kernel or torch.is_grad_enabled()):
            return super().forward(x)
        w, b = self.weight, self.bias
        dev = x.device.type
        if torch.is_autocast_enabled(dev):
            dt = torch.get_autocast_dtype(dev)
            x, w = x.to(dt), w.to(dt)
            b = None if b is None else b.to(dt)
        if self.fwd_kernel:
            x, w = x.contiguous(), w.contiguous()
            if not torch.is_grad_enabled():
                return conv3x3_fwd(x, w)
        return _Conv3x3WgradFn.apply(x, w, b, self.fwd_kernel)


def fwd_kernel_convs(model: nn.Module):
    """The :class:`Conv3x3` modules of ``model`` whose forward runs on the
    conv3x3_fwd kernel (13 in PoseResNet-50, none in the hourglass or
    HRNet); clearing their ``fwd_kernel`` sends them to cuDNN."""
    return [m for m in model.modules()
            if isinstance(m, Conv3x3) and m.fwd_kernel]


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         bias: bool = True, fwd_kernel: bool = False) -> nn.Conv2d:
    """2D conv with torch-style symmetric padding ``(kernel - 1) // 2``;
    a 3x3 stride-1 conv with ``in_ch == out_ch`` is a :class:`Conv3x3`
    (its forward on the conv3x3_fwd kernel if ``fwd_kernel``)."""
    if kernel == 3 and stride == 1 and in_ch == out_ch:
        return Conv3x3(in_ch, out_ch, 3, padding=1, bias=bias,
                       fwd_kernel=fwd_kernel)
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                     padding=(kernel - 1) // 2, bias=bias)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that, with ``relu``, also applies the ReLU that
    follows it, and whose train-mode forward with grad on the card is the
    BatchNorm kernel pair (``ops/batch_norm.py::BatchNormFn``): the same
    running-statistics update, ``num_batches_tracked`` and momentum as
    ``nn.BatchNorm2d``.  In eval mode, under ``no_grad`` and on the CPU it
    is ``nn.BatchNorm2d``'s own forward (then ``F.relu``).  Same
    parameters, buffers and ``state_dict`` keys."""

    def __init__(self, num_features: int, *args, relu: bool = False,
                 **kwargs):
        super().__init__(num_features, *args, **kwargs)
        self.relu = relu

    def extra_repr(self) -> str:
        return super().extra_repr() + (", relu=True" if self.relu else "")

    def takes_kernel(self, x) -> bool:
        """Whether this call runs the kernels: train mode, grad on, on the
        card."""
        return self.training and torch.is_grad_enabled() and x.is_cuda

    def forward(self, x):
        if not self.takes_kernel(x):
            y = super().forward(x)
            return F.relu(y) if self.relu else y
        self._check_input_dim(x)
        factor = 0.0 if self.momentum is None else self.momentum
        if self.track_running_stats and self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:   # cumulative moving average
                factor = 1.0 / float(self.num_batches_tracked)
        tracked = self.track_running_stats
        return BatchNormFn.apply(
            x, self.weight, self.bias,
            self.running_mean if tracked else None,
            self.running_var if tracked else None, factor, self.eps,
            self.relu)


def batch_norm(ch: int, relu: bool = False) -> BatchNorm2d:
    """BatchNorm over ``ch`` channels (eps 1e-5, momentum 0.1), with the
    ReLU that directly follows it when ``relu``."""
    return BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM, relu=relu)


def deconv_padding(kernel: int):
    """(padding, output_padding) of a stride-2 transposed conv that doubles
    H and W, as the reference picks them.

    Kernel 3 (padding 1, output_padding 1) is refused: ``fhpe_tpu``'s
    ``Deconv`` (flax ``ConvTranspose``, padding SAME, with the importer's
    flipped kernel) equals torch's transposed conv for kernels 4 and 2
    but not for 3, where the two place the output a pixel apart (ROADMAP.md
    queue C).  Every config in ``experiments/`` uses kernel 4.
    """
    if kernel == 4:
        return 1, 0
    if kernel == 2:
        return 0, 0
    if kernel == 3:
        raise NotImplementedError(
            "NUM_DECONV_KERNELS 3: fhpe_tpu's Deconv does not match torch's "
            "ConvTranspose2d(k=3, padding=1, output_padding=1) (ROADMAP.md "
            "queue C); use 4 or 2")
    raise ValueError(f"NUM_DECONV_KERNELS must be 4, 3 or 2; got {kernel}")


def deconv_decoder(inplanes: int, num_joints: int, filters: Sequence[int],
                   kernels: Sequence[int], with_bias: bool = False,
                   final_kernel: int = 1) -> Tuple[nn.Sequential, nn.Conv2d]:
    """The classic decoder of PoseResNet and ViTPose: ``(deconv_layers,
    final_layer)``, a ``ConvTranspose2d`` (stride 2) + BatchNorm with its
    ReLU per entry of ``filters`` (at ``deconv_layers.{3i,3i+1}``; an
    ``nn.Identity`` at ``3i+2``, where the reference's ReLU sits), then the
    conv with bias that writes the heatmaps."""
    layers = []
    for kernel, width in zip(kernels, filters):
        padding, output_padding = deconv_padding(kernel)
        layers += [nn.ConvTranspose2d(inplanes, width, kernel, stride=2,
                                      padding=padding,
                                      output_padding=output_padding,
                                      bias=with_bias),
                   batch_norm(width, relu=True), nn.Identity()]
        inplanes = width
    return nn.Sequential(*layers), nn.Conv2d(
        inplanes, num_joints, final_kernel,
        padding=1 if final_kernel == 3 else 0)


def init_decoder(modules) -> None:
    """The reference's decoder init: conv and transposed-conv kernels
    normal(0, 0.001), their biases 0, BatchNorm weight 1 and bias 0."""
    for m in modules:
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.normal_(m.weight, std=0.001)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def drop_rates(depth: int, rate: float) -> np.ndarray:
    """Stochastic depth's drop probability of each of ``depth`` blocks,
    linear from 0 to ``rate`` (float64): the model scales a kept branch by
    its complement, the data layer (``data/drop_path.py``) draws the keep
    flags from it."""
    return np.linspace(0.0, float(rate), depth)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool (reference ``F.max_pool2d(x, 2, 2)``)."""
    return F.max_pool2d(x, 2, 2)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbor upsample (reference ``F.interpolate(scale_factor)``).

    Runs in ``x``'s dtype: CUDA autocast lists the upsample ops as
    float32, which would turn the hourglass's ``up1 + up2`` (and HRNet's
    fuse sums) and what follows into float32 where ``fhpe_tpu`` stays in
    bf16.  Copying values is exact in any dtype.
    """
    with torch.autocast(x.device.type, enabled=False):
        return F.interpolate(x, scale_factor=factor, mode="nearest")


class UpsampleNearest(nn.Module):
    """:func:`upsample_nearest` as a module (the reference's
    ``nn.Upsample(scale_factor, mode='nearest')``; no parameters)."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return upsample_nearest(x, self.factor)


def _downsample(inplanes: int, outplanes: int, stride: int) -> nn.Sequential:
    return nn.Sequential(conv(inplanes, outplanes, 1, stride, bias=False),
                         batch_norm(outplanes))


class BasicBlock(nn.Module):
    """Post-activation residual block, expansion 1, bias-free convs
    (reference ``pose_hrnet.py`` ``BasicBlock``); ``fwd_kernel`` routes
    its 3x3 stride-1 C -> C convs' forwards to the conv3x3_fwd kernel."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, fwd_kernel: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, bias=False,
                          fwd_kernel=fwd_kernel)
        self.bn1 = batch_norm(planes, relu=True)
        self.conv2 = conv(planes, planes, 3, bias=False,
                          fwd_kernel=fwd_kernel)
        self.bn2 = batch_norm(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if downsample else None)

    def forward(self, x):
        out = self.bn1(self.conv1(x))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """Post-activation bottleneck, expansion 4, bias-free convs
    (reference ``pose_hrnet.py`` ``Bottleneck``); ``fwd_kernel`` routes
    a stride-1 ``conv2``'s forward to the conv3x3_fwd kernel."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, fwd_kernel: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1, bias=False)
        self.bn1 = batch_norm(planes, relu=True)
        self.conv2 = conv(planes, planes, 3, stride, bias=False,
                          fwd_kernel=fwd_kernel)
        self.bn2 = batch_norm(planes, relu=True)
        self.conv3 = conv(planes, planes * 4, 1, bias=False)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = (_downsample(inplanes, planes * 4, stride)
                           if downsample else None)

    def forward(self, x):
        out = self.bn1(self.conv1(x))
        out = self.bn2(self.conv2(out))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def bf16_flow_violations(model: nn.Module, x: torch.Tensor):
    """Run ``model(x)`` in the bf16 autocast the Predictor uses; return
    the number of checks (modules whose forward ran, and the heatmaps)
    and the list of those that break ``fhpe_tpu``'s flow, as ``(name,
    input dtype, output dtype)``.

    The flow: every conv, BatchNorm and block of ``model.flow_blocks``
    takes and emits bf16 (the stem conv ``conv1`` takes the float32
    image), and the heatmaps (every stack's, for the hourglass) come out
    float32.  A module that a fused chain bypasses (HRNet's blocks inside
    a ``BranchChain``) never runs and is not counted; the chain is.
    """
    checked = (nn.Conv2d, nn.BatchNorm2d, *model.flow_blocks)
    bad, hooks, ran = [], [], set()

    def hook(name):
        def record(module, inputs, out):
            ran.add(name)
            want = torch.float32 if name == "conv1" else torch.bfloat16
            if inputs[0].dtype != want or out.dtype != torch.bfloat16:
                bad.append((name, inputs[0].dtype, out.dtype))
        return record

    for name, module in model.named_modules():
        if isinstance(module, checked):
            hooks.append(module.register_forward_hook(hook(name)))
    try:
        with torch.inference_mode(), autocast(torch.bfloat16, x.device):
            outs = model(x)
    finally:
        for h in hooks:
            h.remove()
    if isinstance(outs, torch.Tensor):
        outs = [outs]
    bad += [(f"heatmaps.{i}", torch.bfloat16, o.dtype)
            for i, o in enumerate(outs) if o.dtype != torch.float32]
    return len(ran) + len(outs), bad


def _he_scale_draws(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Conv kernels normal(0, sqrt(2 / fan_in)), conv biases normal(0,
    0.1); BatchNorm scale and running variance uniform(0.5, 1.5), bias and
    running mean normal(0, 0.1); numpy, from ``seed``."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, value in model.state_dict().items():
        shape = tuple(value.shape)
        name = key.rsplit(".", 1)[-1]
        if name == "num_batches_tracked":
            sd[key] = torch.zeros_like(value)
            continue
        if name == "weight" and len(shape) == 4:
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(0, np.sqrt(2.0 / fan_in), shape)
        elif name in ("weight", "running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:   # conv and BN biases, running means
            a = rng.normal(0, 0.1, shape)
        sd[key] = torch.from_numpy(a.astype(np.float32))
    return sd


def he_scale_weights(model: nn.Module, seed: int,
                     image_hw) -> Dict[str, torch.Tensor]:
    """Random weights for parity checks, drawn with numpy from ``seed``:
    He-scale conv kernels and random BatchNorm scale and bias, then every
    BatchNorm's running mean and variance taken from one train-mode
    forward of two seeded normal images of ``image_hw`` (H, W), in float32
    on the CPU.

    The reference init (normal(0, 0.001) kernels) gives HRNet heatmaps of
    ~0 that decode to (0, 0) whatever the weights, which no parity check
    could tell apart.  A trained net's BN statistics match its
    activations.  Random ones do
    not, and HRNet's residual sums then roughly double per block, so
    W32's heatmaps grow by many orders of magnitude; with matched
    statistics they stay moderate.
    Leaves ``model`` in eval mode holding the returned weights.
    """
    model.load_state_dict(_he_scale_draws(model, seed))
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    x = np.random.RandomState(seed).randn(2, 3, *image_hw)
    for m in bns:
        m.reset_running_stats()
        m.momentum = None   # cumulative average: one batch sets the stats
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x.astype(np.float32)))
    model.eval()
    for m in bns:
        m.momentum = BN_MOMENTUM
        m.num_batches_tracked.zero_()
    return {k: v.clone() for k, v in model.state_dict().items()}
