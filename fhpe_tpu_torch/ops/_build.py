"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

The sources have a plain C interface, so ``nvcc`` compiles them in
seconds (one ``nvcc -c`` per source, all started together) and links them
into one shared library, loaded with ``ctypes``.  The library
lands in ``build/fhpe_tpu_torch/<hash>/libfhpe_kernels.so`` beside the
package, keyed by a hash of the sources, the headers they share
(``csrc/*.cuh``) and the compiler flags, so a changed source or header is
rebuilt and an unchanged one is loaded as it is.
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
              "-Xcompiler", "-fPIC")
LIB_NAME = "libfhpe_kernels.so"


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _headers():
    return sorted(_CSRC.glob("*.cuh"))


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
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return _BUILD_ROOT / _source_hash() / LIB_NAME


def _run(procs) -> None:
    """Wait for every (cmd, Popen); raise with the output of any failure."""
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile to temporary names, then rename: no process ever loads a
    # half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in _sources()]
        _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)])
              for src, obj in zip(_sources(), objs)])
        lib = os.path.join(tmp, LIB_NAME)
        _run([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs])])
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and type every C entry point."""
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fhpe_decode_heatmaps.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.fhpe_decode_heatmaps.restype = ci
    lib.fhpe_pairwise_oks.argtypes = [vp, vp, vp, vp, ci, ci,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_float, vp]
    lib.fhpe_pairwise_oks.restype = ci
    lib.fhpe_greedy_nms_mask.argtypes = [vp, vp, vp, vp, ci, ctypes.c_float,
                                         vp, vp]
    lib.fhpe_greedy_nms_mask.restype = ci
    lib.fhpe_oks_nms_segments.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                          ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_float, ctypes.c_float, ci,
                                          ci, vp]
    lib.fhpe_oks_nms_segments.restype = ci
    lib.fhpe_conv3x3_wgrad.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                       ci, ci, ctypes.POINTER(ci), vp]
    lib.fhpe_conv3x3_wgrad.restype = ci
    pp = ctypes.POINTER(vp)
    lib.fhpe_branch_chain_eval.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci,
                                           ci, ctypes.POINTER(ci), pp, pp,
                                           pp, pp, pp, ctypes.c_float, vp]
    lib.fhpe_branch_chain_eval.restype = ci
    lib.fhpe_branch_chain_train.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci,
                                            ci, ci, ci, ci, ci,
                                            ctypes.POINTER(ci), pp, pp, pp,
                                            ctypes.c_float, vp]
    lib.fhpe_branch_chain_train.restype = ci
    lib.fhpe_branch_chain_part_tiles.argtypes = [ci, ci, ci, ci,
                                                 ctypes.POINTER(ci)]
    lib.fhpe_branch_chain_part_tiles.restype = ci
    lib.fhpe_conv3x3_fwd.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                     ctypes.POINTER(ci), vp]
    lib.fhpe_conv3x3_fwd.restype = ci
    cf, plan = ctypes.c_float, ctypes.POINTER(ci)
    lib.fhpe_batch_norm_train.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci,
                                          ci, ci, ci, plan, cf, cf, ci, vp]
    lib.fhpe_batch_norm_train.restype = ci
    lib.fhpe_batch_norm_apply.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                          ci, plan, ci, vp]
    lib.fhpe_batch_norm_apply.restype = ci
    lib.fhpe_batch_norm_backward.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                             vp, ci, ci, ci, ci, plan, ci, vp]
    lib.fhpe_batch_norm_backward.restype = ci
    lib.fhpe_cuda_error_string.argtypes = [ci]
    lib.fhpe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.fhpe_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
