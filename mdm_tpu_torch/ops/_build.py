"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

The sources under ``mdm_tpu_torch/csrc/`` have a plain C interface, so they
compile with ``nvcc`` alone (no PyTorch headers): one ``nvcc -c`` per
source, all started together, then one link into a shared library named
by a hash of the sources, headers and flags: a changed source builds anew,
an unchanged one loads from the cache. The library's directory is
``utils/compile_cache.kernel_cache_dir()``, read at each call: by default
``mdm_tpu_torch/_build/`` in the checkout, or what ``MDM_TPU_COMPILE_CACHE``
names. Nothing is built or imported from outside the repository's sources.
The compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is
kept beside the library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"  # the default; build_dir() is the one in force
SOURCES = ("layer_inference.cu", "gemm.cu", "gemm_sm90.cu", "attention_fwd.cu", "attention_bwd.cu",
           "attention_wide.cu", "attention_f32.cu", "attention.cu", "encoder_tail.cu",
           "dropout_bits.cu")
HEADERS = ("common.cuh", "philox.cuh", "attention.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_longlong
# bits, seed, batch offset, threshold, 1/(1-rate), mode (philox.cuh::Dropout)
_DROP = [_P, _I, _I, _U, _F, _I]
_VIEW = [_L, _L, _I]  # batch, head and row strides of an attention operand (attention.cu::View)
# name -> argtypes of each exported C function; every one returns a cudaError_t.
SIGNATURES = {
    "mdm_residual_layernorm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mdm_adaln_modulate": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _I, _P],
    "mdm_gemm_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mdm_colsum": [_P, _P, _P, _I, _I, _I, _I, _P],
    "mdm_gemm_wgmma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "mdm_gemm_wgmma_occupancy": [_I, _I, _I, _I, _P],
    "mdm_attention_fwd": [_P, _P, _P, *_VIEW, _P, *_VIEW, *_DROP, _P, *_VIEW, _I, _P,
                          _I, _I, _I, _I, _I, _P],
    "mdm_attention_bwd": [_P, _P, _P, *_VIEW, _P, *_VIEW, *_DROP, _P, _P, *_VIEW, _P, _P, _P, _P,
                          _P, _I, _I, _I, _I, _I, _P],
    "mdm_attention_fwd_occupancy": [_I, _I, _I, _I, _P],
    "mdm_attention_bwd_occupancy": [_I, _I, _I, _P],
    "mdm_attention_f32_plan": [_I, _P],
    "mdm_tail_ln1_fwd": [_P, _P, *_DROP, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mdm_tail_gelu_dropout": [_P, *_DROP, _P, _P, _I, _I, _I, _I, _P],
    "mdm_tail_ln2_fwd": [_P, _P, *_DROP, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mdm_tail_ln2_bwd": [_P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "mdm_tail_gelu_bwd": [_P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _P],
    "mdm_tail_ln1_bwd": [_P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "mdm_philox_dump": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "mdm_philox_dump3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # PATH, $CUDA_HOME or the default

    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit's nvcc")
    return path


def build_dir() -> Path:
    """Where the library is built and found (``MDM_TPU_COMPILE_CACHE``)."""
    from ..utils.compile_cache import kernel_cache_dir  # utils imports the models, hence ops

    return kernel_cache_dir()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return build_dir() / f"mdm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the hashed library already exists: one
    ``nvcc -c`` per source in parallel, then one link."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        outs = [p.communicate()[0] for p in procs]  # waits for every compile
        log = "".join(f"== {s}\n{o}" for s, o in zip(SOURCES, outs))
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if not failed:
            lib = os.path.join(tmp, "lib.so")
            res = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib, *objs],
                                 capture_output=True, text=True)
            log += f"== link\n{res.stdout}{res.stderr}"
            if res.returncode != 0:
                failed = ["link"]
        so.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log[-8000:]}")
        os.replace(lib, so)  # atomic: a concurrent process never loads a partial library
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


_TEMPLATE_ARG = re.compile(r"Li(\d+)E|Lb([01])E|(f)|(13__nv_bfloat16)")


def instance_name(mangled: str, kernel: str) -> str:
    """kernel<template arguments> of a mangled instance (ints such as a
    head dim, float/bf16 types and bools, in order); the kernel's name for
    a kernel that is no template; the mangled name when they do not parse."""
    t = re.search(re.escape(kernel) + r"I((?:Li\d+E|Lb[01]E|f|13__nv_bfloat16)+)E", mangled)
    if not t:
        return kernel if re.search(r"\d" + re.escape(kernel) + r"E", mangled) else mangled
    args = []
    for n, b, f, _ in _TEMPLATE_ARG.findall(t.group(1)):
        args.append(n if n else ("true" if b == "1" else "false") if b else
                    "float" if f else "bf16")
    return f"{kernel}<{', '.join(args)}>"


def ptxas_report(log: str, kernel: str) -> dict:
    """{instance: registers and spill bytes} of every instance of a kernel
    in a build log (``-Xptxas -v``)."""
    rows, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = instance_name(m.group(1), kernel) if kernel in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rows.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.setdefault(name, {})["registers"] = int(m.group(1))
    return rows


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        msg = load_library().mdm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
