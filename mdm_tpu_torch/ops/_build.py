"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

The sources under ``mdm_tpu_torch/csrc/`` have a plain C interface, so they
compile with ``nvcc`` alone (no PyTorch headers) into one shared library in
``mdm_tpu_torch/_build/``, named by a hash of the sources and flags: a
changed source builds anew, an unchanged one loads from the cache. Nothing
is built or imported from outside the repository. The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside the
library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("layer_inference.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argtypes of each exported C function; every one returns a cudaError_t.
SIGNATURES = {
    "mdm_gemm_bias_act": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mdm_attention_rowmask": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mdm_residual_layernorm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # PATH, $CUDA_HOME or the default

    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit's nvcc")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"mdm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the hashed library already exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-8000:]}")
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mdm_error_string.argtypes = [_I]
    lib.mdm_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        msg = load_library().mdm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
