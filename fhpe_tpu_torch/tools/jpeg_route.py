"""How far the image library's JPEG route lands from the pixels it
encoded, and from libjpeg's decode of the same files.

    python3 -m fhpe_tpu_torch.tools.jpeg_route [--images 64] [--size 256]
        [--write DIR | --check DIR] [--out FILE]

Draws ``--images`` seeded images like the synthetic datasets' (noise in
0-39 and sixteen radius-6 disks, ``data/synthetic.py``), then with the
route this machine's library took (``ops/native_image.py::route``):

* round trip: encode at quality 95, decode, and the max and mean absolute
  difference from the pixels before encoding, with the host ms per
  encode and per decode;
* ``--write DIR``: keeps the encoded files and their decode in ``DIR``
  (``files.npz``), and on the ``libjpeg`` route grayscale versions of the
  images (their channel mean) encoded and decoded too.  On that route
  both are cv2's: its bytes equal ``cv2.imencode``'s and its decode
  ``cv2.imdecode``'s (``tests/test_torch_image.py``);
* ``--check DIR``: decodes ``DIR``'s files with this route and states how
  far that lands from the decode kept there: max, mean, and the share of
  values that differ, for the color files and the grayscale ones (no
  chroma to upsample: the IDCT alone).  Run ``--write`` where the route
  is ``libjpeg`` and ``--check`` on the card to hold nvJPEG's decode to
  cv2's on the same bytes.

Prints one JSON object (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ..ops import native_image

JOINTS = 16


def draw_images(n: int, size: int, seed: int = 0) -> list:
    """``n`` (size, size, 3) uint8 BGR images: noise and joint disks."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = rng.randint(0, 40, size=(size, size, 3), dtype=np.uint8)
        for j in range(JOINTS):
            x, y = rng.randint(16, size - 16, 2)
            native_image.fill_disk(img, (x, y),
                                   (80 + 10 * j, 255 - 10 * j, 200))
        out.append(img)
    return out


def _diff(got: list, want: list) -> dict:
    d = np.stack([np.abs(g.astype(np.int32) - w.astype(np.int32))
                  for g, w in zip(got, want)])
    return {"max_abs": int(d.max()), "mean_abs": float(d.mean()),
            "share_differing": float((d > 0).mean())}


def round_trip(images: list):
    """Encode and decode each image once; the decode's difference from
    the pixels encoded, and host ms per call; then the files and their
    decodes."""
    t0 = time.perf_counter()
    files = [native_image.encode_jpeg(img) for img in images]
    t1 = time.perf_counter()
    decoded = [native_image.decode_jpeg_bytes(f) for f in files]
    t2 = time.perf_counter()
    return {"route": native_image.route(), "images": len(images),
            "shape": list(images[0].shape),
            "encode_ms": (t1 - t0) * 1e3 / len(images),
            "decode_ms": (t2 - t1) * 1e3 / len(images),
            "bytes_per_image": sum(map(len, files)) / len(files),
            "vs_encoded": _diff(decoded, images)}, files, decoded


def _pack(files: list, decoded: list, prefix: str) -> dict:
    return {f"{prefix}lengths": np.array([len(f) for f in files]),
            f"{prefix}data": np.frombuffer(b"".join(files), np.uint8),
            f"{prefix}decoded": np.stack(decoded)}


def _unpack(kept, prefix: str):
    data = kept[f"{prefix}data"].tobytes()
    ends = np.cumsum(kept[f"{prefix}lengths"])
    files = [data[a:b] for a, b in zip(np.r_[0, ends[:-1]], ends)]
    return files, list(kept[f"{prefix}decoded"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--write", type=Path)
    ap.add_argument("--check", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    images = draw_images(args.images, args.size)
    result, files, decoded = round_trip(images)
    if args.write:
        args.write.mkdir(parents=True, exist_ok=True)
        arrays = _pack(files, decoded, "")
        if native_image.route() == "libjpeg":
            gray = [img.mean(-1).astype(np.uint8) for img in images]
            gray_files = [native_image.encode_jpeg(g) for g in gray]
            arrays.update(_pack(gray_files, [native_image.decode_jpeg_bytes(
                f) for f in gray_files], "gray_"))
        np.savez(args.write / "files.npz", route=np.array(
            native_image.route()), **arrays)
        result["wrote"] = str(args.write)
    if args.check:
        kept = np.load(args.check / "files.npz")
        for prefix in ("", "gray_"):
            if f"{prefix}data" not in kept:
                continue
            theirs, want = _unpack(kept, prefix)
            ours = [native_image.decode_jpeg_bytes(f) for f in theirs]
            result[f"{prefix}vs_kept_decode"] = {
                "kept_route": str(kept["route"]), "files": len(theirs),
                **_diff(ours, want)}
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return result


if __name__ == "__main__":
    main()
