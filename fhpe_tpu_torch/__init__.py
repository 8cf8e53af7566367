"""fhpe_tpu_torch — the PyTorch/CUDA port of ``fhpe_tpu`` for NVIDIA Hopper.

The JAX package ``fhpe_tpu`` stays the reference; this package serves the
same models with PyTorch (cuDNN convolutions) and hand-written CUDA
kernels for what ``fhpe_tpu`` wrote in Pallas.  It never imports JAX.

Covered so far: serving the stacked hourglass and HRNet
(``fhpe_tpu_torch.serve.Predictor``) with the heatmap-decode kernel
(``fhpe_tpu_torch.ops.decode``), COCO evaluation
(``fhpe_tpu_torch.cli.common.make_evaluate_fn``) with OKS-NMS on the card
(``fhpe_tpu_torch.ops.nms_torch``: the pairwise OKS and greedy kernels),
and FPD training on one device (``fhpe_tpu_torch.train``) with the 3x3
filter-gradient kernel (``fhpe_tpu_torch.ops.conv_wgrad``) and MPII PCKh.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level exports (keeps ``import fhpe_tpu_torch`` light)."""
    if name in ("load_config", "get_default_config"):
        from . import config
        return getattr(config, name)
    if name == "get_pose_net":
        from .models import get_pose_net
        return get_pose_net
    if name == "Predictor":
        from .serve import Predictor
        return Predictor
    raise AttributeError(name)
