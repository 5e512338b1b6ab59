"""The row-sweep parse as one CUDA FFI call (parse_rows.cu).

`parse_rows(step, starts, row)` returns the same committed mask as
`matcher._parse_rows_xla`, which runs the sweeps as ~1,600 dependent XLA
loop steps per batch; here they are three kernel launches. The library
is built from parse_rows.cu with nvcc at first use on a machine with a
GPU, into `_build/` beside this file (git-ignored), and registered with
XLA as the CUDA target "zzflate_parse_rows". There is no interpret mode:
the CPU always runs the XLA sweeps (matcher._parse_rows picks by the
platform the graph is lowered for).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp

TARGET = "zzflate_parse_rows"

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "parse_rows.cu")
_SO = os.path.join(_HERE, "_build", "libzzflate_parse_rows.so")

_lock = threading.Lock()
_registered = False


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA parse kernel cannot build")
    return path


def build() -> str:
    """Compile parse_rows.cu for sm_90a unless the library is current."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(
        _SRC
    ):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", tmp, _SRC,
    ]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stderr[-4000:]}")
    os.replace(tmp, _SO)
    return _SO


def ensure_registered() -> None:
    """Build (if needed) and register the CUDA target, once per process."""
    global _registered
    if _registered:
        return
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.ZzParseRows), platform="CUDA"
        )
        _registered = True


def parse_rows(step: jax.Array, starts: jax.Array, row: int) -> jax.Array:
    """Committed mask (B, npad) bool of the walk from each start.

    step: (B, npad) int32 in [1, 258] with npad a multiple of row > 258;
    starts: (B,) int32. Lowers only for CUDA."""
    bch, npad = step.shape
    if jax.default_backend() == "gpu":
        ensure_registered()
    mark, _exit, _entries = jax.ffi.ffi_call(
        TARGET,
        (
            jax.ShapeDtypeStruct((bch, npad), jnp.uint8),
            jax.ShapeDtypeStruct((bch, npad), jnp.int32),
            jax.ShapeDtypeStruct((bch, npad // row), jnp.int32),
        ),
    )(step, starts, row=row)
    return mark != 0
