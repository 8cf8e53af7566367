"""Fixed-batch pose predictor for serving, on one CUDA device or several.

Counterpart of ``fhpe_tpu/serve/predictor.py``: a full frame and person
boxes, or uint8 crops and their crop parameters, in; keypoints in
source-image coordinates out.  The whole post-network pipeline stays on
the device: normalize (/255, ImageNet mean/std), forward (bf16 by
default), optional flip test (W-flip the input, ``flip_back``,
SHIFT_HEATMAP, 0.5 average), the decode kernel (argmax + quarter offset,
``ops/csrc/decode.cu``) and the affine map back to the source frame.
Only (x, y, confidence) per joint comes back to the host.

Requests of any size run in chunks padded to the fixed batch.  On the
card the serve step (everything from the uint8 crops to the keypoints) is
one CUDA graph, captured by :meth:`Predictor.warmup` or the first chunk
and replayed for every chunk (``utils/graph.py::CapturedStep``, the
counterpart of ``fhpe_tpu``'s ``jax.jit``); ``Predictor.step.eager`` is
the same step run op by op.  The chunks run double-buffered, as
``fhpe_tpu``'s: one prefetch thread fills chunk k+1 (for
:meth:`Predictor.predict`, crops it from the frame) into a pinned host
slot and starts its upload on a side stream while the device runs chunk
k, and at most ``max_in_flight`` chunks' results wait on the device
before they are read back.

Over several devices the batch splits as ``fhpe_tpu``'s ``shard_map``
splits it: ``batch_size`` is the global batch, and each replica (its own
copy of the model, its own captured step) runs its rows of every chunk.
Eval-mode BatchNorm keeps the rows independent, so no collective is
needed.  One host thread enqueues every replica's step before it reads
any back.

Typical use::

    from fhpe_tpu_torch.serve import Predictor
    p = Predictor.from_checkpoint(cfg, "model_best.msgpack")   # or a .pth
    p.warmup()
    kpts = p.predict(frame, boxes)              # (N, J, 3) in frame coords
    # or, with pre-cropped inputs:
    preds, maxvals = p.predict_crops(crops, centers, scales)
"""

from __future__ import annotations

import copy
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..data import dataset_meta
from ..data.coco import xywh2cs
from ..geometry.affine import get_affine_transform
from ..geometry.flip import flip_back_torch, flip_pair_permutation
from ..models import get_pose_net, is_multi_output
from ..ops import native_image
from ..ops.decode import decode_heatmaps, make_inverse_transforms
from ..ops.preprocess import normalize_images
from ..utils.checkpoint import load_model_weights
from ..utils.dtype import autocast, compute_dtype
from ..utils.graph import CapturedStep, current_device, storage_fingerprint
from ..utils.spans import span, spanned


def xywh_to_center_scale(box, aspect_ratio: float, pixel_std: float = 200.0):
    """Person box (x, y, w, h) -> (center, scale) crop parametrization.

    Thin wrapper over the COCO loader's :func:`..data.coco.xywh2cs`
    (``lib/dataset/coco.py:112-134`` semantics) so the box->crop logic has
    exactly one implementation.
    """
    x, y, w, h = [float(v) for v in box]
    return xywh2cs(x, y, w, h, aspect_ratio, pixel_std)


def replica_devices(cfg, device, n_devices: Optional[int] = None) -> list:
    """The devices a Predictor's replicas run on, in replica order.

    A sequence of devices means exactly those (one device may appear
    more than once).  Otherwise ``n_devices``, or ``TPU.NUM_DEVICES``
    when it is > 0, replicas: ``cuda:k .. cuda:k+n-1`` from ``device``'s
    index (0 for ``"cuda"``), or n CPU replicas.  Left to choose, ``"cuda"``
    takes every visible GPU, and ``"cuda:k"`` and the CPU take one.
    """
    if isinstance(device, (str, torch.device)):
        device = torch.device(device)
        n = n_devices if n_devices is not None else int(cfg.TPU.NUM_DEVICES)
        if n <= 0:
            n = torch.cuda.device_count() \
                if device.type == "cuda" and device.index is None else 1
        if device.type == "cuda":
            first = device.index or 0
            devices = [torch.device("cuda", first + i) for i in range(n)]
        else:
            devices = [device] * n
    else:
        devices = [torch.device(d) for d in device]
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices {n_devices} != the {len(devices)} "
                             f"devices named")
    if not devices:
        raise ValueError(f"no device to serve on (device {device!r}, "
                         f"{torch.cuda.device_count()} CUDA devices visible)")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"replicas on one kind of device; got {devices}")
    return devices


class Predictor:
    """Fixed-batch pose inference on one device or a batch split over
    several.

    Parameters
    ----------
    cfg : the experiment config: model, input/heatmap sizes,
        ``TPU.COMPUTE_DTYPE`` and the TEST.* options FLIP_TEST,
        SHIFT_HEATMAP and POST_PROCESS.
    model : an ``nn.Module`` built for ``cfg`` or a state_dict for it.
    batch_size : the fixed GLOBAL batch every chunk is padded to
        (default ``TEST.BATCH_SIZE_PER_GPU`` times the replicas); each
        replica runs ``batch_size / n`` rows of every chunk.
    device : where the replicas run (default ``"cuda"``), or a sequence
        of devices, one per replica (:func:`replica_devices`).  A CUDA
        device decodes with the CUDA kernel; a CPU device with its plain
        version.
    flip_pairs : the joint pairs the flip test swaps; default the
        registry's for ``DATASET.DATASET``, which must then have
        ``MODEL.NUM_JOINTS`` joints.
    n_devices : the number of replicas (default ``TPU.NUM_DEVICES`` when
        it is > 0, else every visible GPU for ``"cuda"`` and 1 for the
        CPU).

    ``model``, ``device`` and ``step`` are replica 0's; ``models``,
    ``devices`` and ``steps`` list every replica's.
    """

    def __init__(self, cfg, model: Union[nn.Module, Mapping[str, torch.Tensor]],
                 batch_size: Optional[int] = None,
                 device: Union[str, torch.device, Sequence] = "cuda",
                 flip_pairs: Optional[Sequence] = None,
                 n_devices: Optional[int] = None):
        self.cfg = cfg
        self.devices = replica_devices(cfg, device, n_devices)
        n = len(self.devices)
        self.device = self.devices[0]
        self.dtype = compute_dtype(cfg, self.device)
        self.batch_size = int(batch_size or cfg.TEST.BATCH_SIZE_PER_GPU * n)
        if self.batch_size % n:
            raise ValueError(
                f"batch_size {self.batch_size} must divide over "
                f"{n} devices")
        if not isinstance(model, nn.Module):
            state_dict = model
            model = get_pose_net(cfg)
            model.load_state_dict(state_dict)
        # bf16 runs under autocast on float32 parameters (utils.dtype),
        # the heatmaps cast to float32 by the model: fhpe_tpu's flow.
        param_dtype = torch.float64 if self.dtype == torch.float64 \
            else torch.float32
        # replica 0 serves ``model`` itself (moved in place); every other
        # replica a copy of its own, also where two share a device
        self.model = model.to(device=self.device, dtype=param_dtype).eval()
        self.models = [self.model] + [copy.deepcopy(self.model).to(d)
                                      for d in self.devices[1:]]
        self._multi = is_multi_output(model)
        self._input_dtype = param_dtype

        self.image_size = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)  # (W,H)
        self.heatmap_size = tuple(int(v) for v in cfg.MODEL.HEATMAP_SIZE)
        self.aspect_ratio = self.image_size[0] / self.image_size[1]

        self.flip_test = bool(cfg.TEST.FLIP_TEST)
        self.shift_heatmap = bool(cfg.TEST.SHIFT_HEATMAP)
        self.post_process = bool(cfg.TEST.POST_PROCESS)
        self._perm = None
        self._perms = {}        # device -> the flip permutation there
        if self.flip_test:
            num_joints = int(cfg.MODEL.NUM_JOINTS)
            if flip_pairs is None:
                meta = dataset_meta(cfg.DATASET.DATASET)
                if meta["num_joints"] != num_joints:
                    raise ValueError(
                        f"MODEL.NUM_JOINTS={num_joints} != dataset "
                        f"'{cfg.DATASET.DATASET}' joint count "
                        f"{meta['num_joints']}; pass flip_pairs= explicitly "
                        f"for non-registry joint layouts")
                flip_pairs = meta["flip_pairs"]
            perm = flip_pair_permutation(num_joints, flip_pairs)
            self._perms = {d: torch.as_tensor(perm, device=d)
                           for d in self.devices}
            self._perm = self._perms[self.device]
        # per replica: (model, {"image", "inv_trans"}) -> {"preds",
        # "maxvals"}
        self.steps = [CapturedStep(self._serve,
                                   lambda m: storage_fingerprint((m,)))
                      for _ in self.devices]
        self.step = self.steps[0]
        # chunks whose results may wait on the device before they are read
        # back (2 = classic double buffering), as fhpe_tpu's
        self.max_in_flight = 2
        # made at the first request and kept: the prefetch thread, and the
        # threads that cut a chunk's crops for predict (the C warp
        # releases the GIL; a chunk of n boxes wakes at most n of them)
        self._prefetch: Optional[ThreadPoolExecutor] = None
        self._crop_pool: Optional[ThreadPoolExecutor] = None

    # -- construction ------------------------------------------------

    @classmethod
    def from_checkpoint(cls, cfg, path: str, **kw) -> "Predictor":
        """Build from a weight file: a torch ``.pth`` in any of the
        reference's layouts, or ``fhpe_tpu``'s ``.msgpack``
        (``utils/checkpoint.py::load_model_weights``)."""
        return cls(cfg, load_model_weights(path, cfg), **kw)

    # -- inference ---------------------------------------------------

    def _forward(self, model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        with autocast(self.dtype, self.device):
            out = model(x)
        return out[-1] if self._multi else out

    @torch.inference_mode()
    def merged_heatmaps(self, images: torch.Tensor,
                        model: Optional[nn.Module] = None) -> torch.Tensor:
        """(B, H, W, 3) uint8 on a replica's device -> (B, J, h, w)
        heatmaps after the flip-test merge (what the decode step consumes).
        ``model``: that replica's (default replica 0's)."""
        model = self.model if model is None else model
        x = normalize_images(images, self._input_dtype)
        hm = self._forward(model, x)
        if self.flip_test:
            hm_f = flip_back_torch(self._forward(model, x.flip(3)),
                                   self._perms[images.device])
            if self.shift_heatmap:
                hm_f = torch.cat([hm_f[..., :1], hm_f[..., :-1]], dim=3)
            hm = (hm + hm_f) * 0.5
        return hm

    @torch.inference_mode()
    def _serve(self, model, batch) -> dict:
        preds, maxvals = decode_heatmaps(
            self.merged_heatmaps(batch["image"], model), batch["inv_trans"],
            self.post_process)
        return {"preds": preds, "maxvals": maxvals}

    def warmup(self) -> None:
        """Run one zero batch on every replica (cuDNN algorithm choice,
        kernel build) and, on the card, capture each replica's serve
        graph."""
        w, h = self.image_size
        b = self.batch_size // len(self.devices)
        for step, model, dev in zip(self.steps, self.models, self.devices):
            step(model, {
                "image": torch.zeros((b, h, w, 3), dtype=torch.uint8,
                                     device=dev),
                "inv_trans": torch.zeros((b, 2, 3), dtype=torch.float32,
                                         device=dev)})
        if self.device.type == "cuda":
            for dev in set(self.devices):
                torch.cuda.synchronize(dev)

    @spanned("fhpe.serve.request")
    def predict_crops(self, crops, centers, scales):
        """Model-input-sized uint8 crops -> keypoints in source coords.

        crops: (N, H, W, 3) uint8 (H, W = MODEL.IMAGE_SIZE);
        centers/scales: (N, 2) crop parametrization (the affine that
        produced each crop).  Returns (preds (N, J, 2), maxvals (N, J))
        as float32 numpy, in the source-image coordinate frame.  A call is
        one ``fhpe.serve.request`` span (``utils/spans.py``).
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

        def fill(lo, hi, out):
            out[...] = crops[lo:hi]

        return self._run_chunks(n, fill, centers, scales)

    def _executors(self):
        """(prefetch, crop pool), made on first use."""
        if self._prefetch is None:
            self._prefetch = ThreadPoolExecutor(max_workers=1)
            self._crop_pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1))
        return self._prefetch, self._crop_pool

    def _run_chunks(self, n: int, fill: Callable, centers, scales):
        """Run ``n`` crops through the replicas' steps in chunks of the
        global batch, double-buffered.  ``fill(lo, hi, out)`` writes crops
        ``lo:hi`` into ``out`` ((hi - lo, H, W, 3) uint8 numpy); it runs on
        the prefetch thread, ahead of the devices.  Returns (preds,
        maxvals) numpy.

        Each chunk has a host slot (pinned on the card) of the global
        batch, and each replica a device slot of its rows,
        ``max(max_in_flight, 1) + 1`` of each (at most one per chunk),
        reused in turn: the prefetch of chunk k+1 never writes the slot
        chunk k's steps read, whatever ``max_in_flight``.  The prefetch
        thread refills a host slot only after its last uploads ended
        (events), and uploads rows ``r*b:(r+1)*b`` to replica r's slot on
        replica r's side copy stream, which overwrites a device slot only
        after the step that read it was enqueued (an event on replica r's
        current stream).  The main thread enqueues every replica's step
        of a chunk, each followed by the copy of its results to pinned
        host memory, before it reads any back, so reading a chunk waits
        for that chunk and no later one.  On the CPU the replicas' batches
        are row blocks of the host slot and no stream is involved.

        Spans (``utils/spans.py``), on the calling thread:
        ``fhpe.serve.plan`` from entry until chunk 0's fill is handed to
        the prefetch thread (the inverse transforms, slots, events,
        streams), ``fhpe.serve.wait_fill`` while this thread waits for a
        chunk's fill, ``fhpe.serve.readback`` around each chunk's read.
        """
        num_joints = int(self.cfg.MODEL.NUM_JOINTS)
        if n == 0:
            return (np.zeros((0, num_joints, 2), np.float32),
                    np.zeros((0, num_joints), np.float32))
        with span("fhpe.serve.plan"):
            inv = make_inverse_transforms(
                np.asarray(centers), np.asarray(scales), self.heatmap_size)
            b = self.batch_size
            w, h = self.image_size
            cuda = self.device.type == "cuda"
            chunks = -(-n // b)
            nslots = min(max(self.max_in_flight, 1) + 1, chunks)
            per = b // len(self.devices)
            rows = [slice(r * per, (r + 1) * per)
                    for r in range(len(self.devices))]

            def new_slot(device, size, pin=False):
                return (torch.empty((size, h, w, 3), dtype=torch.uint8,
                                    device=device, pin_memory=pin),
                        torch.empty((size, 2, 3), dtype=torch.float32,
                                    device=device, pin_memory=pin))

            host = [new_slot("cpu", b, pin=cuda) for _ in range(nslots)]
            if cuda:        # per replica r: [r][slot], or [r]
                dev = [[new_slot(d, per) for _ in range(nslots)]
                       for d in self.devices]
                uploaded = [[torch.cuda.Event() for _ in range(nslots)]
                            for _ in self.devices]
                read = [[torch.cuda.Event() for _ in range(nslots)]
                        for _ in self.devices]
                copy_streams = [torch.cuda.Stream(d) for d in self.devices]
                currents = [torch.cuda.current_stream(d) for d in self.devices]
            prefetch = self._executors()[0]

        def prep(k):
            """Fill chunk k into its host slot and start its uploads; the
            replicas' batches."""
            s, lo = k % nslots, k * b
            cnt = min(b, n - lo)
            img, itr = host[s]
            if cuda:
                for events in uploaded:     # the slot's last uploads
                    events[s].synchronize()
            fill(lo, lo + cnt, img.numpy()[:cnt])
            itr[:cnt] = torch.from_numpy(inv[lo:lo + cnt])
            img[cnt:] = 0
            itr[cnt:] = 0
            if not cuda:
                return cnt, [{"image": img[rs], "inv_trans": itr[rs]}
                             for rs in rows]
            batches = []
            for r, (d, stream) in enumerate(zip(self.devices, copy_streams)):
                d_img, d_itr = dev[r][s]
                with current_device(d), torch.cuda.stream(stream):
                    stream.wait_event(read[r][s])
                    d_img.copy_(img[rows[r]], non_blocking=True)
                    d_itr.copy_(itr[rows[r]], non_blocking=True)
                    uploaded[r][s].record(stream)
                batches.append({"image": d_img, "inv_trans": d_itr})
            return cnt, batches

        preds, vals = [], []
        pending = deque()

        def read_back(out, r):
            """Start the copy of replica r's results to the host, on its
            current stream right after its step; (host tensors, event)."""
            if not cuda:
                return out, None
            host_out = {k: torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=True)
                        for k, v in out.items()}
            for k, v in out.items():
                host_out[k].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(currents[r])
            return host_out, done

        @spanned("fhpe.serve.readback")
        def drain_one():
            cnt, outs = pending.popleft()
            for _, done in outs:
                if done is not None:
                    done.synchronize()
            preds.append(torch.cat([o["preds"] for o, _ in outs])[:cnt])
            vals.append(torch.cat([o["maxvals"] for o, _ in outs])[:cnt])

        nxt = prefetch.submit(prep, 0)
        for k in range(chunks):
            with span("fhpe.serve.wait_fill"):
                cnt, batches = nxt.result()
            if k + 1 < chunks:
                nxt = prefetch.submit(prep, k + 1)
            outs = []
            for r, batch in enumerate(batches):
                with current_device(self.devices[r]):
                    if cuda:
                        currents[r].wait_event(uploaded[r][k % nslots])
                    # fresh outputs, not the graph's: the next chunk
                    # rewrites those (utils/graph.py::_fresh)
                    out = self.steps[r](self.models[r], batch)
                    if cuda:
                        read[r][k % nslots].record(currents[r])
                    outs.append(read_back(out, r))
            pending.append((cnt, outs))
            while len(pending) > self.max_in_flight:
                drain_one()
        while pending:
            drain_one()
        return torch.cat(preds).numpy(), torch.cat(vals).numpy()

    def crop(self, image: np.ndarray, center, scale,
             out: Optional[np.ndarray] = None) -> np.ndarray:
        """Host affine crop of ``image`` to the model input size: the image
        library's warp (``fhpe_warp_affine_u8``), the pixels of
        ``fhpe_tpu``'s ``TPU.NATIVE_WARP`` path and of the loader.
        ``out``: an (H, W, 3) uint8 array to write the crop into."""
        trans = get_affine_transform(np.asarray(center, np.float64),
                                     np.asarray(scale, np.float64),
                                     0, self.image_size)
        return native_image.warp_affine(image, trans, self.image_size,
                                        out=out)

    @spanned("fhpe.serve.request")
    def predict(self, image: np.ndarray, boxes: Sequence) -> np.ndarray:
        """Full-frame entry: person boxes -> keypoints.

        image: (H, W, 3) uint8 frame (RGB if the model was trained with
        DATASET.COLOR_RGB, the loader convention).  boxes: sequence of
        (x, y, w, h) person boxes.  Returns (N, J, 3) float32 numpy — x, y
        in frame coordinates plus per-joint confidence.  Each chunk's
        crops are cut on the prefetch thread, by up to min(8, nproc)
        threads, while the device runs the chunk before; the pixels equal
        :meth:`crop`'s.  A call is one ``fhpe.serve.request`` span.
        """
        image = np.asarray(image)
        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"image must be (H, W, 3) uint8; got "
                             f"{image.dtype} {image.shape}")
        image = np.ascontiguousarray(image)
        cs = [xywh_to_center_scale(box, self.aspect_ratio) for box in boxes]
        centers = np.array([c for c, _ in cs], np.float32).reshape(-1, 2)
        scales = np.array([s for _, s in cs], np.float32).reshape(-1, 2)

        pool = self._executors()[1]

        def fill(lo, hi, out):
            list(pool.map(lambda i: self.crop(image, centers[i], scales[i],
                                              out=out[i - lo]),
                          range(lo, hi)))

        preds, maxvals = self._run_chunks(len(cs), fill, centers, scales)
        return np.concatenate([preds, maxvals[..., None]],
                              axis=-1).astype(np.float32)
