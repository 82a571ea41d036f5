"""Build and load the port's CUDA kernels.

The sources in ``gcge_tpu_torch/ops/csrc/*.cu`` expose a plain C interface.
They are compiled once, at first use, by ``nvcc`` (one process per source,
all started together, then one link) into one shared library,
``gcge_tpu_torch/_build/libgcge_kernels_<sha>.so``, whose name carries a hash
of the sources and flags, and loaded with :mod:`ctypes`.  A plain C library
builds in seconds, where an extension that includes PyTorch's headers takes
minutes.

Every entry point takes pointers and the CUDA stream as ``c_void_p`` and sizes
as ``c_int64``, and returns the ``cudaGetLastError()`` of its launch;
:func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int64
# argument types of each C entry point, in order
SIGNATURES = {
    "gcge_dia_spmm_f64": (_P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _I, _I,
                          _I, _I, _I, _I, _I, _P),
    "gcge_dia_spmm_f32": (_P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _I, _I,
                          _I, _I, _I, _I, _I, _P),
    "gcge_tall_gram_f64": (_P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _P, _P, _P),
    "gcge_tall_expand_f64": (_P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P, _P),
    "gcge_dmma_tile_check": (_P, _P, _P, _P),
    "gcge_csr_spmm_f64": (_P, _P, _P, _I, _P, _I, _I, _I, _P, _I, _I, _P, _I,
                          _I, _I, _I, _I, _P),
    "gcge_csr_spmm_f32": (_P, _P, _P, _I, _P, _I, _I, _I, _P, _I, _I, _P, _I,
                          _I, _I, _I, _I, _P),
    "gcge_onehot_mask_probe": (_P, _P, _P),
    "gcge_fma_probe": (_P, _P, _P, _P),
    "gcge_slice_gram": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                        _P),
    "gcge_bf16_mma_tile_check": (_P, _P, _P, _P),
}

_lib = None


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot be "
                           "built")
    return path


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libgcge_kernels_{h.hexdigest()[:16]}.so")


def _finish(cmd: list[str], proc: subprocess.Popen) -> None:
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{stdout}{stderr}")


def build() -> str:
    """Compile the sources into the shared library unless it exists: every
    source to an object file, all at once, then one link."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects, running = [], []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            objects.append(obj)
            running.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failure = None
        for cmd, proc in running:         # wait for all, report the first
            try:
                _finish(cmd, proc)
            except RuntimeError as exc:
                failure = failure or exc
        if failure is not None:
            raise failure
        lib_tmp = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objects]
        _finish(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
        os.replace(lib_tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


_SMS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """SMs of a card, read once per device: the launch plans of kernels 3,
    4 and 9 size their grids by it."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _SMS[idx]


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
