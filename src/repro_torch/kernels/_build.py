"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface, ``build/<name>-<hash>.so`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The hash covers the source and the flags, so a library is rebuilt only when
its source changes. ``build_all()`` starts one nvcc per source, all at once,
and waits for them. Every C entry point launches on the stream it is handed
(PyTorch's current stream) and returns ``cudaGetLastError()``; ``check``
raises on anything but 0. Launch counts live in ``launch_counts``: a wrapper
adds one exactly where it launches its kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from ctypes import c_float, c_int, c_longlong, c_void_p
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library name -> {C function: argtypes}; every function returns int
SIGNATURES: Dict[str, Dict[str, list]] = {
    "paged_cache": {
        # pool, rows, write_slot, write_off, NB, BS, row_bytes, S, stream
        "repro_paged_scatter": [c_void_p, c_void_p, c_void_p, c_void_p,
                                c_int, c_int, c_longlong, c_int, c_void_p],
        # pool, table, n_live, out, S, MB, block_bytes, NB, stream
        "repro_paged_gather": [c_void_p, c_void_p, c_void_p, c_void_p,
                               c_int, c_int, c_longlong, c_int, c_void_p],
    },
    "paged_attention": {
        # q, k_pool, v_pool, table, lengths, part_m, part_l, part_acc, out,
        # S, H, KVh, hd, NB, BS, MB, blocks_per_split, scale, q_dtype,
        # kv_dtype, stream
        "repro_paged_attention_decode": [
            c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,
            c_void_p, c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_int,
            c_int, c_int, c_int, c_float, c_int, c_int, c_void_p],
    },
}

launch_counts: Dict[str, int] = {"paged_scatter": 0, "paged_gather": 0,
                                 "paged_attention_decode": 0}

_libs: Dict[str, ctypes.CDLL] = {}


def count_launch(kernel: str) -> None:
    launch_counts[kernel] += 1


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Dict]:
    """Compile every library whose hashed ``.so`` is missing, one nvcc per
    source started together. Returns ``{name: {"seconds", "log", "cached"}}``
    and raises with nvcc's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in SIGNATURES:
        so = library_path(name)
        if so.exists():
            out[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "log": log,
                     "cached": False}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name``, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not so.exists():
        build_all()
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = c_int
    lib.repro_error_string.argtypes = [c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} ({msg})")
