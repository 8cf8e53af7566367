"""Milliseconds per step of every BatchNorm kernel on the device, from the
traced stretch: ATen's native ones (``batch_norm_collect_statistics``,
``batch_norm_transform_input``, ``batch_norm_backward`` and their kin),
cuDNN's (``bn_fw_*``, ``bn_bw_*``) and the port's train-mode pair
(``ops/csrc/batch_norm.cu``: ``bn_train_partials``, ``bn_train_apply``,
``bn_grad_partials``, ``bn_grad_input``), by their CUDA function names.
The teachers' eval-mode BatchNorm is counted too."""

from .. import trace
from ._shares import per_step

BN_KERNELS = r"batch_norm_|\bbn_(fw|bw)_|\bbn_(train|grad)_"


def read(r):
    v = per_step(r, trace.kernel_s(r["events"], BN_KERNELS) * 1e3)
    return v if v else None
