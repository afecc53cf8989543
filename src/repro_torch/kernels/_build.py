"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface, ``build/<name>-<hash>.so`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

Each library links only the CUDA runtime: flash attention fetches the
driver API's ``cuTensorMapEncodeTiled`` (its TMA descriptors) at run time
through ``cudaGetDriverEntryPoint``, so no ``-lcuda`` is needed. The hash
covers the source and the flags, so a library is rebuilt only when its
source changes. ``build_all()`` starts one nvcc per source, all at once,
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
        # k_pool, k_rows, v_pool, v_rows (null: one pool), write_slot,
        # write_off, NB, BS, row_bytes, S, stream
        "repro_paged_scatter": [c_void_p, c_void_p, c_void_p, c_void_p,
                                c_void_p, c_void_p, c_int, c_int, c_longlong,
                                c_int, c_void_p],
        # pool, table, n_live, out, S, MB, block_bytes, NB, stream
        "repro_paged_gather": [c_void_p, c_void_p, c_void_p, c_void_p,
                               c_int, c_int, c_longlong, c_int, c_void_p],
        # k_pool, k_scales, k_rows, v_pool, v_scales, v_rows (null: one
        # pool), write_slot, write_off, NB, BS, row_elems, S, row_dtype,
        # quant_dtype, stream
        "repro_paged_scatter_quant": [c_void_p, c_void_p, c_void_p, c_void_p,
                                      c_void_p, c_void_p, c_void_p, c_void_p,
                                      c_int, c_int, c_int, c_int, c_int,
                                      c_int, c_void_p],
    },
    "paged_attention": {
        # q, k_pool, v_pool, k_scale, v_scale, table, lengths, part_m,
        # part_l, part_acc, out, S, H, KVh, hd, NB, BS, MB, blocks_per_split,
        # KV heads a CTA, scale, q_dtype, kv_dtype, stream
        "repro_paged_attention_decode": [
            c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,
            c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_int, c_int,
            c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_float, c_int,
            c_int, c_void_p],
    },
    "fused_losses": {
        # x, t, labels, out, res, T, V, v_real, vectors per split, splits,
        # mode, dtype, stream
        "repro_fused_loss_fwd": [c_void_p, c_void_p, c_void_p, c_void_p,
                                 c_void_p, c_int, c_int, c_int, c_int, c_int,
                                 c_int, c_int, c_void_p],
        # x, t, labels, logZ_s, logZ_t, E, g_nll, g_smooth, g_dist, ds, dt,
        # T, V, v_real, mode, dtype, inv_v, two_inv_v, stream
        "repro_fused_loss_bwd": [c_void_p] * 11 + [c_int] * 5
                                + [c_float, c_float, c_void_p],
    },
    "flash_attention": {
        # q, k, v, out, B, S, T, H, KVh, hd, causal, window, scale, dtype,
        # stream
        "repro_flash_attention": [c_void_p, c_void_p, c_void_p, c_void_p,
                                  c_int, c_int, c_int, c_int, c_int, c_int,
                                  c_int, c_int, c_float, c_int, c_void_p],
    },
}

launch_counts: Dict[str, int] = {
    "paged_scatter": 0, "paged_gather": 0, "paged_attention_decode": 0,
    "paged_attention_decode_quant": 0, "paged_scatter_quant": 0,
    "fused_cross_entropy": 0,
    "fused_cross_entropy_parts": 0, "fused_cross_entropy_grad": 0,
    "fused_ce_distill_parts": 0, "fused_ce_distill_grad": 0,
    "fused_distill_loss": 0, "fused_distill_kl_parts": 0,
    "fused_distill_mse_grad": 0, "fused_distill_kl_grad": 0,
    "flash_attention": 0}

_libs: Dict[str, ctypes.CDLL] = {}


def count_launch(kernel: str) -> None:
    launch_counts[kernel] += 1


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def runs_plain(dev: torch.device) -> bool:
    """Whether a wrapper given tensors on ``dev`` runs its plain version
    (the CPU) rather than launch its kernel (CUDA). Any other device
    (``meta`` included) raises: a kernel runs on the card, a plain version
    on the CPU, and nothing else computes."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, not "
                         f"{dev.type!r}")
    return dev.type == "cpu"


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


def bind(so: Path, name: str) -> ctypes.CDLL:
    """Load the shared library ``so`` built from ``csrc/<name>.cu`` (or a
    copy of it) and type its C functions."""
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = c_int
    lib.repro_error_string.argtypes = [c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name``, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not so.exists():
        build_all()
    lib = _libs[name] = bind(so, name)
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} ({msg})")
