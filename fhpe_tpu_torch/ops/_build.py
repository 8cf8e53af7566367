"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

The sources have a plain C interface, so ``nvcc`` compiles them in
seconds into one shared library, loaded with ``ctypes``.  The library
lands in ``build/fhpe_tpu_torch/<hash>/libfhpe_kernels.so`` beside the
package, keyed by a hash of the sources and the compiler flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.
Nothing is built at import: the first call of :func:`load_library` builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "fhpe_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
LIB_NAME = "libfhpe_kernels.so"


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.isfile(nvcc):
        return nvcc
    if shutil.which("nvcc"):
        return shutil.which("nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from fhpe_tpu_torch/ops/csrc")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return _BUILD_ROOT / _source_hash() / LIB_NAME


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: no process ever loads a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and type every C entry point."""
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fhpe_decode_heatmaps.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.fhpe_decode_heatmaps.restype = ci
    lib.fhpe_cuda_error_string.argtypes = [ci]
    lib.fhpe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.fhpe_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
