"""The port's host image library: JPEG codec, cv2-parity warp and resize,
joint disks.

Counterpart of ``fhpe_tpu/ops/native_image.py`` (ctypes bindings of
``ops/cpp/imagedec.cpp``).  The port has no cv2 and no PIL, so everything
the data path does to pixels goes through here:

* :func:`decode_jpeg_bytes` / :func:`imread`: ``cv2.imread(path,
  IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION)`` for JPEG files, BGR or RGB;
  anything that is not a JPEG raises ``ValueError``;
* :func:`encode_jpeg` / :func:`imwrite`: ``cv2.imwrite`` of a ``.jpg``
  (quality 95, baseline, 4:2:0);
* :func:`warp_affine`: ``cv2.warpAffine(img, M, dsize,
  flags=INTER_LINEAR)``, with ``flip_src`` to warp ``img[:, ::-1]``
  without the copy (``fhpe_warp_affine_u8``, the same C text as
  ``fhpe_tpu``'s);
* :func:`resize`: ``cv2.resize(img, dsize, interpolation=INTER_LINEAR)``
  on uint8, bit-equal (``fhpe_resize_linear_u8``, OpenCV's fixed-point
  arithmetic; an exact halving takes INTER_AREA's 2x2 mean, as cv2 does;
  ``tests/test_torch_device_warp.py``): the letterbox canvas of
  ``TPU.DEVICE_WARP``;
* :func:`fill_disk`: ``cv2.circle(img, center, 6, color, -1)``, through
  :func:`stamp`, which sets any fixed mask at an integer centre (the debug
  images' dots, ``utils/vis.py``).

The library is C++ with a plain C interface, built by g++ at first use
into ``build/fhpe_tpu_torch/<hash>/libfhpe_image.so`` (apart from the nvcc
kernels: this needs no CUDA compiler), keyed by a hash of the sources, the
route and the flags, written under a temporary name and moved into place
so parallel test workers never load a half-written file.  Its JPEG codec
takes one of two routes, chosen by what the machine has and named by
:func:`route`:

* ``libjpeg``: ``jpeglib.h`` is there; ``imagedec.cpp``'s libjpeg-turbo
  codec, bit-equal to cv2 (decode) and byte-equal to ``cv2.imencode``
  (encode; ``tests/test_torch_image.py``);
* ``nvjpeg``: no ``jpeglib.h``, but the CUDA toolkit ships nvJPEG
  (``ops/cpp/jpeg_nvjpeg.cpp``, same C signatures); not held to libjpeg's
  IDCT, its difference is measured by ``tools/jpeg_route.py``.

Neither found, or the chosen route fails to build: :func:`build` raises
with what it found.  No route stands in for another.  ctypes releases the
GIL for each call, so the loader's threads decode and warp in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_CPP = Path(__file__).resolve().parent / "cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "fhpe_tpu_torch"
# fhpe_tpu/ops/cpp/Makefile's flags: -ffp-contract=off keeps the warp's
# row-base mul+add unfused, which its cv2 parity depends on
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-ffp-contract=off")
LIB_NAME = "libfhpe_image.so"
ROUTES = ("libjpeg", "nvjpeg")
JPEG_QUALITY = 95            # cv2.imwrite's default
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)

# cv2.circle(img, c, 6, color, -1) (8-connected, not anti-aliased) fills
# exactly these pixels of the 13 x 13 box around c (113 of them; held to
# cv2 in tests/test_torch_image.py)
DISK = np.array([[ch == "#" for ch in row] for row in (
    "......#......",
    "...#######...",
    "..#########..",
    ".###########.",
    ".###########.",
    ".###########.",
    "#############",
    ".###########.",
    ".###########.",
    ".###########.",
    "..#########..",
    "...#######...",
    "......#......")])


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def probe() -> dict:
    """What the machine offers for a JPEG codec: whether ``jpeglib.h``
    preprocesses with g++, and nvJPEG's header and library under
    ``CUDA_HOME``."""
    try:
        proc = subprocess.run([CXX, "-E", "-x", "c++", "-"],
                              input="#include <jpeglib.h>\n",
                              capture_output=True, text=True, timeout=60)
        jpeglib = proc.returncode == 0
    except OSError:
        jpeglib = False
    cuda = Path(_cuda_home())
    return {"jpeglib_h": jpeglib,
            "nvjpeg_h": (cuda / "include" / "nvjpeg.h").is_file(),
            "libnvjpeg": (cuda / "lib64" / "libnvjpeg.so").exists(),
            "cuda_home": str(cuda)}


def choose_route(found: Optional[dict] = None) -> str:
    """``libjpeg`` where ``jpeglib.h`` is, else ``nvjpeg`` where the CUDA
    toolkit has it; raises where neither is."""
    found = probe() if found is None else found
    if found["jpeglib_h"]:
        return "libjpeg"
    if found["nvjpeg_h"] and found["libnvjpeg"]:
        return "nvjpeg"
    raise RuntimeError(
        "no JPEG codec to build the image library with: no jpeglib.h for "
        f"g++ and no nvJPEG under CUDA_HOME (probe: {found})")


def _command(route: str, out: str) -> list:
    sources = [str(_CPP / "imagedec.cpp")]
    if route == "libjpeg":
        return [CXX, *CXXFLAGS, "-shared", "-o", out, *sources, "-ljpeg"]
    if route == "nvjpeg":
        cuda = _cuda_home()
        return [CXX, *CXXFLAGS, "-DFHPE_NO_LIBJPEG",
                f"-I{cuda}/include", "-shared", "-o", out, *sources,
                str(_CPP / "jpeg_nvjpeg.cpp"), f"-L{cuda}/lib64",
                f"-Wl,-rpath,{cuda}/lib64", "-lnvjpeg", "-lcudart"]
    raise ValueError(f"unknown image library route {route!r}; one of "
                     f"{ROUTES}")


def library_path(route: str) -> Path:
    h = hashlib.sha256(" ".join(_command(route, LIB_NAME)).encode())
    for src in sorted(_CPP.glob("*.cpp")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build(route: Optional[str] = None) -> Path:
    """Compile the library for ``route`` (default :func:`choose_route`)
    unless it exists; returns its path."""
    route = route or choose_route()
    out = library_path(route)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, LIB_NAME)
        cmd = _command(route, lib)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"the image library's {route} route did not build "
                f"({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}\n"
                f"probe: {probe()}")
        os.replace(lib, out)
    return out


_load_lock = threading.Lock()


def _loaded() -> Tuple[ctypes.CDLL, str]:
    with _load_lock:   # the loader's threads reach the first call together
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[ctypes.CDLL, str]:
    name = choose_route()
    lib = ctypes.CDLL(str(build(name)))
    ci, i64 = ctypes.c_int, ctypes.c_int64
    cip = ctypes.POINTER(ci)
    lib.fhpe_jpeg_dims.argtypes = [_u8p, i64, cip, cip, cip]
    lib.fhpe_jpeg_dims.restype = ci
    lib.fhpe_jpeg_decode.argtypes = [_u8p, i64, _u8p, i64, ci]
    lib.fhpe_jpeg_decode.restype = ci
    lib.fhpe_jpeg_encode.argtypes = [_u8p, ci, ci, ci, ci, ci, _u8p, i64,
                                     _i64p]
    lib.fhpe_jpeg_encode.restype = ci
    lib.fhpe_warp_affine_u8.argtypes = [
        _u8p, ci, ci, ci, _u8p, ci, ci, ctypes.POINTER(ctypes.c_double), ci,
        ci]
    lib.fhpe_warp_affine_u8.restype = None
    lib.fhpe_resize_linear_u8.argtypes = [_u8p, ci, ci, ci, _u8p, ci, ci]
    lib.fhpe_resize_linear_u8.restype = None
    return lib, name


def get_lib() -> ctypes.CDLL:
    """The library, built if needed and loaded once per process."""
    return _loaded()[0]


def route() -> str:
    """The JPEG route of the loaded library: ``libjpeg`` or ``nvjpeg``."""
    return _loaded()[1]


_SOF_MARKERS = frozenset(
    range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}  # SOF0-15 minus DHT/JPG/DAC


def _jpeg_dims_fast(buf: bytes) -> Optional[Tuple[int, int]]:
    """(height, width) from the SOF marker, scanning segment lengths.

    Pure-Python so the C decoder does not have to parse the header twice
    (jpeg_read_header also builds quant/huffman state — measurable per
    sample on the hot loader path).  Returns None on anything unusual;
    the caller then falls back to the C header parse."""
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None
    i = 2
    n = len(buf)
    while i + 3 < n:
        if buf[i] != 0xFF:
            return None
        marker = buf[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if 0xD0 <= marker <= 0xD9 or marker == 0x01:  # RST/SOI/EOI/TEM
            i += 2
            continue
        seg_len = (buf[i + 2] << 8) | buf[i + 3]
        if seg_len < 2:
            return None
        if marker in _SOF_MARKERS:
            if i + 9 >= n:
                return None
            h = (buf[i + 5] << 8) | buf[i + 6]
            w = (buf[i + 7] << 8) | buf[i + 8]
            return (h, w) if h > 0 and w > 0 else None
        i += 2 + seg_len
    return None


def decode_jpeg_bytes(buf: bytes, bgr: bool = True,
                      name: str = "<bytes>") -> np.ndarray:
    """A JPEG byte string as (H, W, 3) uint8, BGR or RGB; ``ValueError``
    (naming ``name``) if it is not a JPEG the codec can decode."""
    if buf[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (the port's image "
                         "library reads JPEG only)")
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    dims = _jpeg_dims_fast(buf)
    if dims is None:
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.fhpe_jpeg_dims(src.ctypes.data_as(_u8p), src.size,
                                ctypes.byref(w), ctypes.byref(h),
                                ctypes.byref(c))
        if rc:
            raise ValueError(f"{name}: unreadable JPEG header (code {rc}, "
                             f"{route()} route)")
        dims = (h.value, w.value)
    out = np.empty((dims[0], dims[1], 3), dtype=np.uint8)
    rc = lib.fhpe_jpeg_decode(src.ctypes.data_as(_u8p), src.size,
                              out.ctypes.data_as(_u8p), out.nbytes,
                              1 if bgr else 0)
    if rc:
        raise ValueError(f"{name}: JPEG decode failed (code {rc}, "
                         f"{route()} route)")
    return out


def imread(path: str, bgr: bool = True) -> np.ndarray:
    """A JPEG file as (H, W, 3) uint8 (see :func:`decode_jpeg_bytes`)."""
    with open(path, "rb") as f:
        return decode_jpeg_bytes(f.read(), bgr=bgr, name=path)


def encode_jpeg(img: np.ndarray, quality: int = JPEG_QUALITY,
                bgr: bool = True) -> bytes:
    """(H, W, 3) uint8 (BGR, or RGB with ``bgr=False``) or (H, W) as a
    baseline JPEG; the ``nvjpeg`` route takes three channels only."""
    lib = get_lib()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    ch = 1 if img.ndim == 2 else img.shape[2]
    cap = img.nbytes + (1 << 16)
    for _ in range(2):
        out = np.empty(cap, dtype=np.uint8)
        length = ctypes.c_int64()
        rc = lib.fhpe_jpeg_encode(img.ctypes.data_as(_u8p), img.shape[0],
                                  img.shape[1], ch, 1 if bgr else 0,
                                  int(quality), out.ctypes.data_as(_u8p),
                                  cap, ctypes.byref(length))
        if rc == 4:            # the stream outgrew the buffer: size it
            cap = length.value
            continue
        if rc:
            raise ValueError(f"JPEG encode of a {img.shape} image failed "
                             f"(code {rc}, {route()} route)")
        return out[:length.value].tobytes()
    raise ValueError(f"JPEG encode of a {img.shape} image: buffer size")


def imwrite(path: str, img: np.ndarray, quality: int = JPEG_QUALITY) -> None:
    """Write a BGR image as ``cv2.imwrite(path, img)`` writes a ``.jpg``."""
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)


def warp_affine(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int],
                flip_src: bool = False,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """cv2.warpAffine(img, M, dsize, flags=INTER_LINEAR) — bit exact up to
    +-1 at exact .5 ties.

    ``dsize`` is (width, height), cv2 convention.  ``flip_src`` warps as
    if ``img[:, ::-1]`` had been passed, without materializing the flip.
    ``out``: a C-contiguous uint8 array of the result's shape to write
    into (a pinned batch slot, say) instead of a new one.
    """
    lib = get_lib()
    img = np.ascontiguousarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, ch = img.shape
    dw, dh = int(dsize[0]), int(dsize[1])
    m = np.ascontiguousarray(M, dtype=np.float64)
    shape = (dh, dw) if squeeze else (dh, dw, ch)
    if out is None:
        out = np.empty(shape, dtype=np.uint8)
    elif (out.shape != shape or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous uint8 {shape}; got "
                         f"{out.dtype} {out.shape}")
    lib.fhpe_warp_affine_u8(
        img.ctypes.data_as(_u8p), h, w, ch,
        out.ctypes.data_as(_u8p), dh, dw,
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 0,
        1 if flip_src else 0)
    return out


def resize(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, dsize, interpolation=INTER_LINEAR) on uint8 (H, W)
    or (H, W, C), C <= 4 — bit-equal (``fhpe_resize_linear_u8``): an
    exact halving takes INTER_AREA's 2x2 mean as cv2 does, equal sizes
    copy.  ``dsize`` is (width, height), cv2 convention."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and not 1 <= img.shape[2] <= 4):
        raise ValueError(f"resize takes uint8 (H, W) or (H, W, 1..4); got "
                         f"{img.dtype} {img.shape}")
    dw, dh = int(dsize[0]), int(dsize[1])
    if dw <= 0 or dh <= 0 or 0 in img.shape:
        raise ValueError(f"resize of a {img.shape} image to {dsize}")
    lib = get_lib()
    squeeze = img.ndim == 2
    src = img[:, :, None] if squeeze else img
    h, w, ch = src.shape
    out = np.empty((dh, dw, ch), dtype=np.uint8)
    lib.fhpe_resize_linear_u8(src.ctypes.data_as(_u8p), h, w, ch,
                              out.ctypes.data_as(_u8p), dh, dw)
    return out[:, :, 0] if squeeze else out


def stamp(img: np.ndarray, mask: np.ndarray, center: Tuple[int, int],
          color) -> None:
    """Set the pixels of the boolean ``mask`` (odd sides, centred on the
    integer ``center`` (x, y)) to ``color`` in place, clipped to the
    image: a fixed shape of ``cv2.circle`` at an integer centre."""
    x, y = int(center[0]), int(center[1])
    ry, rx = mask.shape[0] // 2, mask.shape[1] // 2
    h, w = img.shape[:2]
    y0, y1 = max(y - ry, 0), min(y + ry + 1, h)
    x0, x1 = max(x - rx, 0), min(x + rx + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    img[y0:y1, x0:x1][mask[y0 - (y - ry):y1 - (y - ry),
                           x0 - (x - rx):x1 - (x - rx)]] = color


def fill_disk(img: np.ndarray, center: Tuple[int, int], color) -> None:
    """Paint :data:`DISK` at integer ``center`` (x, y) in place on a uint8
    image, clipped to it, ``color`` saturated to 0-255:
    ``cv2.circle(img, center, 6, color, -1)``."""
    stamp(img, DISK, center, np.clip(np.asarray(color), 0, 255
                                     ).astype(np.uint8))
