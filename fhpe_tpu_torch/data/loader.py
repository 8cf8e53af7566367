"""Host-side data pipeline: augmentation, affine crop, batching, prefetch.

Counterpart of ``fhpe_tpu/data/loader.py``.  Per-sample semantics mirror
``JointsDataset.__getitem__`` (JointsDataset.py:113-198): half-body
transform, scale/rotation jitter with the reference's exact
distributions, horizontal flip with pair swap, one affine warp
(INTER_LINEAR on uint8) to the network input size.

The port has no cv2, so every pixel goes through its own image library
(``ops/native_image.py``): the JPEG decode, and the warp
``fhpe_warp_affine_u8``, which reads the source mirrored (``flip_src``)
for a flipped training sample instead of warping a flipped copy.  That is
``fhpe_tpu``'s ``TPU.NATIVE_DECODE`` + ``TPU.NATIVE_WARP`` path, taken
whatever those flags say, so neither selects anything here: the warp
equals cv2's up to +-1 at exact .5 ties (``tests/test_native_image.py``),
and the decode is cv2's libjpeg on the library's ``libjpeg`` route (on
its ``nvjpeg`` route it is not bit-equal; ``ops/native_image.py``).
A file that is not a JPEG raises.  With ``TPU.DEVICE_WARP`` a training
sample is instead a letterbox canvas (``TPU.CANVAS_SIZE``, the image
resized into it by the library's ``resize``, bit-equal to cv2's) and the
output->canvas affine, with the flip folded into it; the step crops on
the device.  Evaluation keeps the host warp.

Split of responsibilities, as in ``fhpe_tpu``:
* host (this module): decode + augment-params + single uint8 warp — the
  irreducibly variable-shape work; runs in a thread pool (the library's
  ctypes calls release the GIL) with batches prefetched ahead of the
  device.
* device (``train/step.py::make_batch_preprocessor``): /255 + mean/std
  normalize and Gaussian target generation.  Batches ship as uint8 (4x
  less host->device traffic than float32).

``half_body_transform``, ``compose_mirror``, ``collate``, ``BatchLoader``,
``PoseDataSource.draw_augment_params`` and the decoded-cache accounting
(``TPU.DECODE_CACHE_MB``) are copies, pinned to ``fhpe_tpu``'s by
``tests/test_torch_port_hygiene.py``.
"""

from __future__ import annotations

import random as pyrandom
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..geometry.affine import affine_transform, get_affine_transform
from ..geometry.flip import fliplr_joints
from ..geometry.targets import generate_target_np
from ..ops import native_image
from ..utils import zipreader

# Process-global decoded-cache accounting (TPU.DECODE_CACHE_MB): one byte
# pool shared by every PoseDataSource in the process so the knob bounds
# TOTAL cache RSS (train images + finished eval samples), not per-source
# multiples of it.  Each source's reservations are returned to the pool
# when the source is garbage-collected (weakref.finalize), so sequential
# runs in one process don't starve later caches.
_cache_lock = threading.Lock()
_cache_used = [0]


def _return_cache_bytes(reserved_cell):
    with _cache_lock:
        _cache_used[0] -= reserved_cell[0]
        reserved_cell[0] = 0


def _read_image(path: str, color_rgb: bool) -> np.ndarray:
    """A JPEG file, or a JPEG entry of ``archive.zip@inner/path``, as
    (H, W, 3) uint8: RGB when ``color_rgb``, else BGR (cv2's order)."""
    if ".zip@" in path:
        return zipreader.imread(path, bgr=not color_rgb)
    return native_image.imread(path, bgr=not color_rgb)


def half_body_transform(joints, joints_vis, num_joints, upper_body_ids,
                        aspect_ratio, rng, pixel_std: float = 200.0):
    """Reference half-body crop (JointsDataset.py:65-108)."""
    upper, lower = [], []
    for jid in range(num_joints):
        if joints_vis[jid][0] > 0:
            (upper if jid in upper_body_ids else lower).append(joints[jid])

    if rng.randn() < 0.5 and len(upper) > 2:
        selected = upper
    else:
        selected = lower if len(lower) > 2 else upper
    if len(selected) < 2:
        return None, None

    selected = np.array(selected, dtype=np.float32)
    center = selected.mean(axis=0)[:2]
    left_top = np.amin(selected, axis=0)
    right_bottom = np.amax(selected, axis=0)
    w = right_bottom[0] - left_top[0]
    h = right_bottom[1] - left_top[1]
    if w > aspect_ratio * h:
        h = w * 1.0 / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / pixel_std, h / pixel_std], dtype=np.float32) * 1.5
    return center, scale


def compose_mirror(inv_trans: np.ndarray, width_used: float) -> np.ndarray:
    """Prepend a horizontal mirror (about ``width_used`` pixels) to a
    dst->src affine: src_x' = (width_used - 1) - src_x."""
    m = np.array([[-1.0, 0.0, width_used - 1.0],
                  [0.0, 1.0, 0.0]], dtype=np.float64)
    homo = np.concatenate([inv_trans, [[0.0, 0.0, 1.0]]], axis=0)
    return (m @ homo).astype(np.float64)


class PoseDataSource:
    """db -> augmented fixed-size samples (the __getitem__ equivalent)."""

    def __init__(self, cfg, db: List[dict], is_train: bool, flip_pairs,
                 upper_body_ids, joints_weight=None, seed: int = 0):
        self.cfg = cfg
        self.db = db
        self.is_train = is_train
        self.flip_pairs = flip_pairs
        self.upper_body_ids = upper_body_ids
        self.joints_weight = joints_weight

        self.num_joints = int(cfg.MODEL.NUM_JOINTS)
        self.image_size = np.array(cfg.MODEL.IMAGE_SIZE)
        self.heatmap_size = np.array(cfg.MODEL.HEATMAP_SIZE)
        self.sigma = cfg.MODEL.SIGMA
        self.aspect_ratio = self.image_size[0] / self.image_size[1]
        self.scale_factor = cfg.DATASET.SCALE_FACTOR
        self.rotation_factor = cfg.DATASET.ROT_FACTOR
        self.flip = cfg.DATASET.FLIP
        self.num_joints_half_body = cfg.DATASET.NUM_JOINTS_HALF_BODY
        self.prob_half_body = cfg.DATASET.PROB_HALF_BODY
        self.color_rgb = cfg.DATASET.COLOR_RGB
        self.use_diff_weight = cfg.LOSS.USE_DIFFERENT_JOINTS_WEIGHT
        self.device_warp = bool(cfg.TPU.get("DEVICE_WARP", False))
        self.canvas_size = tuple(cfg.TPU.get("CANVAS_SIZE", [512, 512]))
        self.rng = np.random.RandomState(seed)
        self.pyrng = pyrandom.Random(seed)
        # Decoded-image RAM cache (TPU.DECODE_CACHE_MB): from epoch 2 the
        # pipeline skips the JPEG decode while augmentation stays fully
        # random.  Eval samples are deterministic end-to-end, so for them
        # the FINISHED sample (warp + targets) is cached.  Thread notes:
        # plain dict get/set under the GIL; a rare racing double-decode
        # wastes one decode, never corrupts (arrays are immutable once
        # inserted).  The byte budget is PROCESS-GLOBAL (shared across all
        # sources), so DECODE_CACHE_MB bounds total cache RSS.
        self._cache_budget = int(cfg.TPU.get("DECODE_CACHE_MB", 0)) * (1 << 20)
        self._img_cache: Dict[str, np.ndarray] = {}
        self._sample_cache: Dict = {}
        self._reserved_cell = [0]
        import weakref
        weakref.finalize(self, _return_cache_bytes, self._reserved_cell)

    def _cache_reserve(self, nbytes: int) -> bool:
        with _cache_lock:
            if _cache_used[0] + nbytes > self._cache_budget:
                return False
            _cache_used[0] += nbytes
            self._reserved_cell[0] += nbytes
            return True

    def _cache_put(self, key, arr: np.ndarray) -> None:
        if self._cache_reserve(arr.nbytes):
            arr.setflags(write=False)
            self._img_cache[key] = arr

    def _read_cached(self, path: str) -> np.ndarray:
        if self._cache_budget <= 0:
            return _read_image(path, self.color_rgb)
        img = self._img_cache.get(path)
        if img is not None:
            return img
        img = _read_image(path, self.color_rgb)
        self._cache_put(path, img)
        return img

    def __len__(self):
        return len(self.db)

    def draw_augment_params(self, idx: int) -> Dict:
        """Consume the augmentation RNG streams for sample ``idx`` and return
        the resolved parameters (center/scale after half-body + scale jitter,
        rotation, flip decision).

        All draws depend only on the db record (never on pixels), so they can
        be made on the submitting thread in deterministic order and shipped to
        pool workers — training augmentations are then reproducible for a
        fixed seed regardless of thread scheduling (the shared RandomState is
        never touched concurrently).  Draw order/conditions are exactly the
        reference's ``__getitem__`` sequence (JointsDataset.py:145-165).
        """
        rec = self.db[idx]
        joints = np.array(rec["joints_3d"], copy=True)
        joints_vis = np.array(rec["joints_3d_vis"], copy=True)
        # preserve the record's dtype: COCO stores center/scale float32 and
        # the reference's affine construction rounds accordingly (MPII is
        # float64); see geometry/affine.get_affine_transform
        c = np.array(rec["center"], copy=True)
        s = np.array(rec["scale"], copy=True)

        if (np.sum(joints_vis[:, 0]) > self.num_joints_half_body
                and self.rng.rand() < self.prob_half_body):
            c_hb, s_hb = half_body_transform(
                joints, joints_vis, self.num_joints, self.upper_body_ids,
                self.aspect_ratio, self.rng)
            if c_hb is not None and s_hb is not None:
                c, s = c_hb, s_hb

        sf, rf = self.scale_factor, self.rotation_factor
        s = s * np.clip(self.rng.randn() * sf + 1, 1 - sf, 1 + sf)
        r = (np.clip(self.rng.randn() * rf, -rf * 2, rf * 2)
             if self.pyrng.random() <= 0.6 else 0)
        flipped = bool(self.flip and self.pyrng.random() <= 0.5)
        return {"c": c, "s": s, "r": r, "flipped": flipped}

    def _canvas_field(self, img, c, s, r, flipped) -> Dict:
        """``TPU.DEVICE_WARP``: the image letterboxed into a fixed
        ``CANVAS_SIZE`` canvas (resized to fit, top-left, zero padding) and
        the composed output->canvas affine; the crop itself runs on the
        device (``ops/preprocess.py::warp_affine`` in the step).  A flip
        folds into the matrix: the pixels are never flipped on the host."""
        wc, hc = self.canvas_size
        h_img, w_img = img.shape[:2]
        fit = min(wc / w_img, hc / h_img)
        rw, rh = int(round(w_img * fit)), int(round(h_img * fit))
        canvas = np.zeros((hc, wc, 3), np.uint8)
        canvas[:rh, :rw] = native_image.resize(img, (rw, rh))
        inv = get_affine_transform(c, s, r, self.image_size, inv=True)
        if flipped:
            inv = compose_mirror(inv, w_img)
        # source -> canvas coords with the resize's pixel-center
        # convention: canvas_x = (src_x + 0.5) * fit_x - 0.5, i.e. scale
        # each row by the per-axis fit AND shift the translation column
        # by 0.5*fit - 0.5 (a pure row scale would bias every crop
        # ~0.5*(1-fit) px toward the top-left).
        fx, fy = rw / w_img, rh / h_img
        warp_inv = inv * np.array([[fx], [fy]])
        warp_inv[0, 2] += 0.5 * fx - 0.5
        warp_inv[1, 2] += 0.5 * fy - 0.5
        return {"canvas": canvas, "warp_inv": warp_inv.astype(np.float32)}

    def get_sample(self, idx: int, host_targets: bool = False,
                   params: Optional[Dict] = None) -> Dict:
        if not self.is_train and self._cache_budget > 0:
            cached = self._sample_cache.get((idx, host_targets))
            if cached is not None:
                return cached

        rec = self.db[idx]
        img = self._read_cached(rec["image"])
        joints = np.array(rec["joints_3d"], copy=True)
        joints_vis = np.array(rec["joints_3d_vis"], copy=True)
        score = rec.get("score", 1)

        if self.is_train:
            if params is None:
                params = self.draw_augment_params(idx)
            c, s, r = params["c"].copy(), params["s"].copy(), params["r"]
            flipped = params["flipped"]
            if flipped:
                # the warp reads the source mirrored (flip_src below): the
                # pixels are never flipped on the host
                joints, joints_vis = fliplr_joints(
                    joints, joints_vis, img.shape[1], self.flip_pairs)
                c[0] = img.shape[1] - c[0] - 1
        else:
            # rec dtype preserved (float32 for COCO, float64 for MPII) so
            # the eval warp matrix is bit-identical to the reference's
            c = np.array(rec["center"], copy=True)
            s = np.array(rec["scale"], copy=True)
            r = 0
            flipped = False

        trans = get_affine_transform(c, s, r, self.image_size)

        # the device warp applies to training only; evaluation keeps the
        # host warp (decode and metrics comparable with the reference)
        if self.device_warp and self.is_train:
            image_field = self._canvas_field(img, c, s, r, flipped)
        else:
            image_field = {"image": native_image.warp_affine(
                img, trans,
                (int(self.image_size[0]), int(self.image_size[1])),
                flip_src=flipped)}  # uint8, already contiguous

        for i in range(self.num_joints):
            if joints_vis[i, 0] > 0.0:
                joints[i, 0:2] = affine_transform(joints[i, 0:2], trans)

        sample = {
            **image_field,
            "joints": joints[:, :2].astype(np.float32),
            "joints_vis": joints_vis[:, 0].astype(np.float32),
            "center": c.astype(np.float32),
            "scale": s.astype(np.float32),
            "rotation": np.float32(r),
            "flipped": np.bool_(flipped),
            "score": np.float32(score),
            "image_path": rec["image"],
        }
        if host_targets:
            tgt, tw = generate_target_np(
                joints, joints_vis, self.heatmap_size, self.image_size,
                self.sigma, self.joints_weight, self.use_diff_weight)
            sample["target"] = np.transpose(tgt, (1, 2, 0))  # NHWC
            sample["target_weight"] = tw[:, 0]

        if not self.is_train and self._cache_budget > 0:
            nbytes = sum(v.nbytes for v in sample.values()
                         if isinstance(v, np.ndarray))
            if self._cache_reserve(nbytes):
                self._sample_cache[(idx, host_targets)] = sample
        return sample


def collate(samples: List[Dict], pad_to: Optional[int] = None) -> Dict:
    """Stack samples into a batch dict; pad by repeating the last sample.

    Adds ``valid`` (B,) marking real vs padded entries (eval-tail masking).
    """
    n = len(samples)
    total = pad_to or n
    valid = np.zeros(total, np.bool_)
    valid[:n] = True
    while len(samples) < total:
        samples = samples + [samples[-1]]

    batch = {}
    for key in samples[0]:
        if key == "image_path":
            batch[key] = [s[key] for s in samples]
        else:
            batch[key] = np.stack([np.asarray(s[key]) for s in samples])
    batch["valid"] = valid
    return batch


class BatchLoader:
    """Epoch iterator with thread-pool sample loading and batch prefetch."""

    def __init__(self, source: PoseDataSource, batch_size: int,
                 shuffle: bool = True, drop_last: bool = False,
                 host_targets: bool = False, num_threads: int = 8,
                 prefetch: int = 2, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        """``batch_size`` is the GLOBAL batch.  Multi-host: construct with
        this process's (index, count) and the same seed everywhere; every
        process draws the identical global permutation and yields its own
        contiguous ``batch_size/process_count`` slice of each global batch
        (matching ``shard_batch``'s process-local assembly)."""
        if batch_size % max(process_count, 1):
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"process_count {process_count}")
        if process_count > 1 and not drop_last:
            # A partial final global batch can leave some processes an
            # empty slice -> unequal batch counts across hosts -> the SPMD
            # step deadlocks.  Refuse the combination outright.
            raise ValueError(
                "process-sharded loading requires drop_last=True (a "
                "partial final global batch would yield unequal batch "
                "counts across processes and deadlock the SPMD step)")
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.host_targets = host_targets
        self.process_index = process_index
        self.process_count = max(process_count, 1)
        self.rng = np.random.RandomState(seed)
        # Two pools: batch-level tasks block on sample-level tasks, so they
        # must NOT share workers (num_threads <= prefetch would deadlock).
        self.pool = ThreadPoolExecutor(max_workers=num_threads)
        self.batch_pool = ThreadPoolExecutor(max_workers=max(1, prefetch))
        self.prefetch = prefetch
        # Retire the worker threads when the loader is dropped: a process
        # that constructs many loaders (tests, multi-run drivers) must not
        # accumulate num_threads+prefetch parked threads per loader.
        import weakref
        self._finalizer = weakref.finalize(
            self, BatchLoader._shutdown_pools, self.pool, self.batch_pool)

    @staticmethod
    def _shutdown_pools(pool, batch_pool):
        batch_pool.shutdown(wait=False)
        pool.shutdown(wait=False)

    def close(self):
        """Explicitly retire the loader's thread pools (idempotent)."""
        self._finalizer()

    def __len__(self):
        n = len(self.source)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_batch(self, idxs, params):
        samples = list(self.pool.map(
            lambda ip: self.source.get_sample(ip[0], self.host_targets,
                                              params=ip[1]),
            zip(idxs, params)))
        return collate(samples,
                       pad_to=self.batch_size // self.process_count)

    def _submit(self, idxs):
        # Augmentation draws happen HERE, on the iterating thread, in batch
        # order — never in pool workers — so training augmentations are
        # reproducible for a fixed seed regardless of thread scheduling.
        if self.source.is_train:
            params = [self.source.draw_augment_params(i) for i in idxs]
        else:
            params = [None] * len(idxs)
        return self.batch_pool.submit(self._load_batch, idxs, params)

    def __iter__(self):
        n = len(self.source)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        batches = [order[i:i + bs] for i in range(0, n, bs)]
        if self.drop_last and len(batches) and len(batches[-1]) < bs:
            batches.pop()
        if self.process_count > 1:
            # this process's contiguous slice of every global batch (mesh
            # device order is process-major, so slice k maps to host k)
            loc = bs // self.process_count
            lo = self.process_index * loc
            batches = [b[lo:lo + loc] for b in batches]
            batches = [b for b in batches if len(b)]

        futures = []
        it = iter(batches)
        for _ in range(self.prefetch):
            idxs = next(it, None)
            if idxs is not None:
                futures.append(self._submit(idxs))
        while futures:
            batch = futures.pop(0).result()
            idxs = next(it, None)
            if idxs is not None:
                futures.append(self._submit(idxs))
            yield batch
