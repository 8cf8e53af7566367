"""Fixed-batch pose predictor for serving, on one CUDA device.

Counterpart of ``fhpe_tpu/serve/predictor.py``: uint8 crops and their
crop parameters in, keypoints in source-image coordinates out.  The
whole post-network pipeline stays on the device: normalize (/255,
ImageNet mean/std), forward (bf16 by default), optional flip test
(W-flip the input, ``flip_back``, SHIFT_HEATMAP, 0.5 average), the decode
kernel (argmax + quarter offset, ``ops/csrc/decode.cu``) and the affine
map back to the source frame.  Only (x, y, confidence) per joint comes
back to the host.

Requests of any size run in chunks padded to the fixed batch.  On the
card the serve step (everything from the uint8 crops to the keypoints) is
one CUDA graph, captured by :meth:`Predictor.warmup` or the first chunk
and replayed for every chunk (``utils/graph.py::CapturedStep``, the
counterpart of ``fhpe_tpu``'s ``jax.jit``); ``Predictor.step.eager`` is
the same step run op by op.  Results stay on the device until the
request's last chunk is queued.

Typical use::

    from fhpe_tpu_torch.serve import Predictor
    p = Predictor.from_checkpoint(cfg, "model_best.pth")
    p.warmup()
    preds, maxvals = p.predict_crops(crops, centers, scales)

Not ported yet (``ROADMAP.md``): ``predict(image, boxes)`` and ``crop``,
and serving over several devices.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ..data import dataset_meta
from ..geometry.flip import flip_back_torch, flip_pair_permutation
from ..models import get_pose_net, is_multi_output
from ..ops.decode import decode_heatmaps, make_inverse_transforms
from ..ops.preprocess import normalize_images
from ..utils.dtype import autocast, compute_dtype
from ..utils.graph import CapturedStep, storage_fingerprint


def load_state_dict_file(path: str) -> dict:
    """Read a reference ``.pth``: raw state_dict, ``module.``-prefixed, or
    a checkpoint dict with ``state_dict`` / ``best_state_dict``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    elif isinstance(ckpt, dict) and "best_state_dict" in ckpt:
        ckpt = ckpt["best_state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in ckpt.items()}


class Predictor:
    """Fixed-batch pose inference on one device.

    Parameters
    ----------
    cfg : the experiment config: model, input/heatmap sizes,
        ``TPU.COMPUTE_DTYPE`` and the TEST.* options FLIP_TEST,
        SHIFT_HEATMAP and POST_PROCESS.
    model : an ``nn.Module`` built for ``cfg`` or a state_dict for it.
    batch_size : the fixed batch every chunk is padded to
        (default ``TEST.BATCH_SIZE_PER_GPU``).
    device : where the model runs (default ``"cuda"``).  A CUDA device
        decodes with the CUDA kernel; a CPU device with its plain version.
    """

    def __init__(self, cfg, model: Union[nn.Module, Mapping[str, torch.Tensor]],
                 batch_size: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        if int(cfg.TPU.NUM_DEVICES) > 1:
            raise NotImplementedError(
                "serving over several devices is not ported yet (ROADMAP.md "
                "queue A: multi-GPU serving); set TPU.NUM_DEVICES to 1 or -1")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = compute_dtype(cfg, self.device)
        self.batch_size = int(batch_size or cfg.TEST.BATCH_SIZE_PER_GPU)
        if not isinstance(model, nn.Module):
            state_dict = model
            model = get_pose_net(cfg)
            model.load_state_dict(state_dict)
        # bf16 runs under autocast on float32 parameters (utils.dtype),
        # the heatmaps cast to float32 by the model: fhpe_tpu's flow.
        param_dtype = torch.float64 if self.dtype == torch.float64 \
            else torch.float32
        self.model = model.to(device=self.device, dtype=param_dtype).eval()
        self._multi = is_multi_output(model)
        self._input_dtype = param_dtype

        self.image_size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)  # (W,H)
        self.heatmap_size = tuple(int(v) for v in cfg.MODEL.HEATMAP_SIZE)

        self.flip_test = bool(cfg.TEST.FLIP_TEST)
        self.shift_heatmap = bool(cfg.TEST.SHIFT_HEATMAP)
        self.post_process = bool(cfg.TEST.POST_PROCESS)
        self._perm = None
        if self.flip_test:
            num_joints = int(cfg.MODEL.NUM_JOINTS)
            meta = dataset_meta(cfg.DATASET.DATASET)
            if meta["num_joints"] != num_joints:
                raise ValueError(
                    f"MODEL.NUM_JOINTS={num_joints} != dataset "
                    f"'{cfg.DATASET.DATASET}' joint count "
                    f"{meta['num_joints']}")
            self._perm = torch.as_tensor(
                flip_pair_permutation(num_joints, meta["flip_pairs"]),
                device=self.device)
        # (model, {"image", "inv_trans"}) -> {"preds", "maxvals"}
        self.step = CapturedStep(self._serve,
                                 lambda m: storage_fingerprint((m,)))

    # -- construction ------------------------------------------------

    @classmethod
    def from_checkpoint(cls, cfg, path: str, **kw) -> "Predictor":
        """Build from a torch ``.pth`` in any of the reference's layouts."""
        return cls(cfg, load_state_dict_file(path), **kw)

    # -- inference ---------------------------------------------------

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with autocast(self.dtype, self.device):
            out = self.model(x)
        return out[-1] if self._multi else out

    @torch.inference_mode()
    def merged_heatmaps(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device -> (B, J, h, w) heatmaps after
        the flip-test merge (what the decode step consumes)."""
        x = normalize_images(images, self._input_dtype)
        hm = self._forward(x)
        if self.flip_test:
            hm_f = flip_back_torch(self._forward(x.flip(3)), self._perm)
            if self.shift_heatmap:
                hm_f = torch.cat([hm_f[..., :1], hm_f[..., :-1]], dim=3)
            hm = (hm + hm_f) * 0.5
        return hm

    @torch.inference_mode()
    def _serve(self, model, batch) -> dict:
        preds, maxvals = decode_heatmaps(self.merged_heatmaps(batch["image"]),
                                         batch["inv_trans"], self.post_process)
        return {"preds": preds, "maxvals": maxvals}

    def warmup(self) -> None:
        """Run one zero batch (cuDNN algorithm choice, kernel build) and,
        on the card, capture the serve graph."""
        w, h = self.image_size
        b = self.batch_size
        self.step(self.model, {
            "image": torch.zeros((b, h, w, 3), dtype=torch.uint8,
                                 device=self.device),
            "inv_trans": torch.zeros((b, 2, 3), dtype=torch.float32,
                                     device=self.device)})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict_crops(self, crops, centers, scales):
        """Model-input-sized uint8 crops -> keypoints in source coords.

        crops: (N, H, W, 3) uint8 (H, W = MODEL.IMAGE_SIZE);
        centers/scales: (N, 2) crop parametrization (the affine that
        produced each crop).  Returns (preds (N, J, 2), maxvals (N, J))
        as float32 numpy, in the source-image coordinate frame.
        """
        crops = np.asarray(crops)
        if crops.dtype != np.uint8:
            raise ValueError(
                f"crops must be uint8 in [0, 255]; got dtype {crops.dtype} "
                f"(float crops are NOT rescaled — convert explicitly, e.g. "
                f"np.clip(x * 255, 0, 255).astype(np.uint8))")
        crops = np.ascontiguousarray(crops)
        w, h = self.image_size
        if crops.ndim != 4 or crops.shape[1:] != (h, w, 3):
            raise ValueError(f"crops must be (N, {h}, {w}, 3); got "
                             f"{crops.shape}")
        n = crops.shape[0]
        if len(centers) != n or len(scales) != n:
            raise ValueError(f"need one center and scale per crop: {n} "
                             f"crops, {len(centers)} centers, "
                             f"{len(scales)} scales")
        inv = make_inverse_transforms(np.asarray(centers),
                                      np.asarray(scales), self.heatmap_size)
        b = self.batch_size
        preds, vals = [], []
        for lo in range(0, n, b):
            hi = min(lo + b, n)
            img = torch.zeros((b, h, w, 3), dtype=torch.uint8)
            itr = torch.zeros((b, 2, 3), dtype=torch.float32)
            img[:hi - lo] = torch.from_numpy(crops[lo:hi])
            itr[:hi - lo] = torch.from_numpy(inv[lo:hi])
            # fresh tensors, not the graph's: the next chunk rewrites those
            out = self.step(self.model, {"image": img.to(self.device),
                                         "inv_trans": itr.to(self.device)})
            preds.append(out["preds"][:hi - lo])
            vals.append(out["maxvals"][:hi - lo])
        num_joints = int(self.cfg.MODEL.NUM_JOINTS)
        if not preds:
            return (np.zeros((0, num_joints, 2), np.float32),
                    np.zeros((0, num_joints), np.float32))
        return (torch.cat(preds).cpu().numpy(),
                torch.cat(vals).cpu().numpy())
