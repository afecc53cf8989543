#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py [--phases device,build,kernels,train_peers]

Drives the port's serving and training paths (``src/repro_torch``) on the
card and checks them, phase by phase; any failure raises and the script
exits non-zero:

  1. device   — a CUDA card or exit 1; print its nvidia-smi name and power
                limit; TF32 off for the parity phases.
  2. build    — compile the CUDA kernels (one nvcc per source, together);
                registers and spills of the flash and decode kernels.
  3. kernels  — each kernel against its plain PyTorch version, with kernel,
                plain and library-call times from CUDA events:
                the paged-KV kernels at the fleet's shapes (qwen2-7b: S=16
                slots, H=28, KVh=4, hd=128, BS=16, MB=34, NB=1025; ragged
                lengths incl. 0, dead table entries aimed at a NaN-poisoned
                free block), in bf16 and fp32, and over int8 and fp8 pools
                (the quantizing scatter bit-exact, the gather of an int8
                pool and its scales bit-exact, the dequantizing decode with
                fp32 and bf16 q); the K+V and single-pool scatters also at
                three pool sizes, NB = 1025 (main), 4097 (k2) and 16385
                (full), bit-exact over fp32 / bf16 pools and over int8 /
                fp8 pools from fp32 and bf16 rows, timed beside two
                index_put_ calls, the launch floor and their host time per
                call; the decode also
                at 16 slots ragged to 4k (k2) and one slot at 32k (k3),
                bf16 held element by element, beside a streaming read of
                its bytes after the same flush; the
                standalone forward CE (T=4096, V=152064 bf16; ragged fp32,
                unaligned bf16, labels out of range) and flash attention
                (qwen1.5-0.5b training and qwen2-7b 4k prefill shapes, a
                1024 window, ragged, non-causal T != S, rows masked in
                every column, windows that skip whole tiles, each in fp32
                and in bf16 on the tensor cores, and bf16 off a 16-byte
                boundary; bf16 held element by element); the
                eight loss kernels (CE,
                CE + distill and distill alone, forward and backward, mse
                and kl, the target gradient written and skipped) at the
                training main path's shape (T=4096, V=152064, bf16) and at
                ragged ones (T=37, V=1000 fp32, also with v_real < V; V=700
                bf16 with unaligned rows); the distillation kernels also
                at the subsample shape (T=512, V=152064, bf16).
  4. fleet    — qwen2-7b at full width and depth (28 layers, bf16 weights
                and pools, seeded random weights), 2 peers, 24 bursty
                requests through ``FleetRouter.run`` on the fused path,
                with launch counts checked against the decode ticks; then
                one decode tick through the gather path (``--fused-attention
                off``) on the same weights and pool, against the fused tick;
                then the same peers and workload over int8 and fp8 pools
                (launch counts of the quantizing scatter and decode checked,
                a fused-vs-gather tick over each). One scatter launch a
                layer writes both pools; each tick's wall time and device
                busy share are printed.
  5. parity   — reduced qwen2-7b in fp32: the port on the card and on the
                CPU (plain versions) with the same weights and workload;
                teacher-forced logits within 1e-4, equal ``FleetReport``s;
                over int8 and fp8 pools the same counts, logits within 1e-3
                of their scale, and pools that differ, where they do, by
                one quantization step in at most 0.1% of the elements,
                after the prefill inserts and after 4 decode ticks.
  6. ops      — the standalone entries ``ops.cross_entropy_tokens`` (T=4096,
                V=152064 bf16) and ``ops.attention`` (the kernels phase's
                flash shapes a-c), launches counted, outputs against the
                plain versions.
  7. train    — qwen1.5-0.5b at full width and depth (24 layers, d_model
                1024, V=152064; fp32 master weights from a seeded
                generator, bf16 activations): 2 codistilling peers, 10 steps
                of mse codistillation with AdamW at batch 8 x seq 512 per
                peer (task loss must fall), a codist eval, 2 all-reduce
                steps and 2 kl codist steps, launch counts checked per run;
                ms per step, device-busy share and top kernels from
                torch.profiler, peak memory.
  8. train_peers — the same model and batch through ``train_codist`` with
                the other exchanges: (a) 3 peers, mse, 6 steps and an
                eval, then 2 kl steps (task loss must fall); (b) 2 peers,
                a subsample wire of 64 tokens, 2 mse and 2 kl steps; (c)
                the checkpoint exchange, 2 peers, period 2, 3 steps; (d)
                the pipelined exchange, 2 peers, 3 steps (alpha 0 on step
                0); (e) a top-k wire of 64, 2 peers, 2 steps. Launch counts
                per distilling step checked against codist_loss's loop;
                ms per step, device-busy share, peak memory.
  9. sweep    — the paper-grid harness at qwen1.5-0.5b's full width: a
                YAML spec (model_overrides restoring get_config, batch 8 x
                seq 512 a peer, 10 steps, the five modes under a constant
                and a burn-in alpha: 9 cells) through
                ``repro_torch.launch.sweep.main``, then ``--resume`` (all
                skipped, nothing launched); per cell the task loss falls,
                the launches match the mode's loss loop and async
                comm_bytes is the wire's bytes times its deliveries; wall,
                ms per step, peak memory, the aggregate's gaps and codist
                steps/s per card.
 10. async    — ``AsyncScheduler`` at full width and 12 of 24 layers (the
                depth cut keeps the script in its time budget): 2 peers
                and an elastic join, kl, 5 steps under a straggler, a
                preemption and a failure recovered from a snapshot,
                staleness bound 1;
                restore, staleness and launches (rows 6, 7, 9, 11)
                checked; ms per peer step and per publish forward, the
                device-busy share of two rounds, peak memory; then the
                training CLI in ``codist-async`` on the card.
 11. train_parity — reduced qwen1.5-0.5b in fp32: 3 codist steps on the
                card through the kernels and on the CPU through their plain
                versions, same weights and batches: 2 peers mse and kl, 3
                peers mse, a subsample wire, the checkpoint and the
                pipelined exchange; then the async runtime at staleness
                bound 0 against the sync exchange on the card, and under
                the async phase's faults card against CPU; per-step losses
                within 1e-4 relative.
 12. spec     — peer-speculative decoding (k = 4, ring pairing) at
                qwen2-7b's full width and depth with the fleet phase's
                FleetConfig and bursty workload: identical peers and a
                noised copy of peer 0 over bf16 pools, identical peers over
                int8 and fp8 pools and through the gather path, each run
                plain and speculative (everything completes, nothing lost
                or duplicated, rows 1-4 launched exactly as the ticks and
                rounds imply; accept rate, tokens equal to the plain run's
                and wall per round against k plain ticks printed); a
                verify against k plain ticks on 16 live slots over bf16,
                int8 and fp8 pools (printed); then in fp32
                (TF32 off) at 4 layers: speculative streams equal plain
                ones token for token, verify argmax equal to plain decode
                at every position, and restore_rows leaving the pools bit
                for bit as they were (fp32, gather path, int8, fp8).
 13. fleet_codist — qwen1.5-0.5b at full width and depth: the async
                runtime writes snapshots (peer 1 failing at step 2); 3
                serving peers refresh from them (keep-last, a stale one
                dropped, the bytes billed); the ensemble policy with its
                canaries (row 8 once a pair, each pair's mse held against
                the plain version; rows 1, 2 and 8 launched exactly as the
                ticks and pairs imply); a defended chaos run with a
                preemption, a failure revived from the async snapshot, a
                straggler and hedging (nothing lost or duplicated); then
                the ensemble, canary + refresh, chaos + hedge and
                speculative runs in fp32 on the card and on the CPU
                (reduced config), every FleetReport field equal.

The kernels phase also holds row 1 at the verify's shape (16 slots x k = 4
pseudo-slots, the plain tick's split plan): against the plain version at the
same plan, and each pseudo-slot bit for bit against the 16-slot decode; and
row 8 at the canary's shape, one (1, 152064) fp32 pair.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of the JAX reference.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "fleet", "parity", "ops", "train",
          "train_peers", "sweep", "async", "train_parity", "spec",
          "fleet_codist")

# main-path shapes (qwen2-7b fleet: FleetConfig(max_slots=16, block_size=16,
# num_blocks=1025, max_blocks_per_slot=34))
S, H, KVH, HD, BS, MB, NB = 16, 28, 4, 128, 16, 34, 1025
LENGTHS = [0, 1, 15, 16, 17, 31, 47, 100, 255, 256, 300, 401, 511, 512, 530,
           543]
POISON = 1           # a free block filled with NaN, named only by dead entries

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32, bf16 FLOP/s and
# int8 / fp8 OP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.int8: 1979e12, torch.float8_e4m3fn: 1979e12}
QUANT = (torch.int8, torch.float8_e4m3fn)

SOURCES = {
    "paged_scatter": ("src/repro_torch/csrc/paged_cache.cu",
                      "src/repro/kernels/paged_cache.py:114"),
    "paged_gather": ("src/repro_torch/csrc/paged_cache.cu",
                     "src/repro/kernels/paged_cache.py:60"),
    "paged_attention_decode": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:101"),
    "paged_attention_decode_quant": ("src/repro_torch/csrc/paged_attention.cu",
                                     "src/repro/kernels/paged_attention.py:54"),
    "paged_scatter_quant": ("src/repro_torch/csrc/paged_cache.cu",
                            "src/repro/kernels/paged_cache.py:219"),
    "fused_cross_entropy": ("src/repro_torch/csrc/fused_losses.cu",
                            "src/repro/kernels/fused_ce.py:117"),
    "fused_cross_entropy_parts": ("src/repro_torch/csrc/fused_losses.cu",
                                  "src/repro/kernels/fused_ce.py:177"),
    "fused_cross_entropy_grad": ("src/repro_torch/csrc/fused_losses.cu",
                                 "src/repro/kernels/fused_ce.py:219"),
    "fused_ce_distill_parts": ("src/repro_torch/csrc/fused_losses.cu",
                               "src/repro/kernels/combined_loss.py:119"),
    "fused_ce_distill_grad": ("src/repro_torch/csrc/fused_losses.cu",
                              "src/repro/kernels/combined_loss.py:195"),
    "fused_distill_loss": ("src/repro_torch/csrc/fused_losses.cu",
                           "src/repro/kernels/distill_loss.py:136"),
    "fused_distill_kl_parts": ("src/repro_torch/csrc/fused_losses.cu",
                               "src/repro/kernels/distill_loss.py:171"),
    "fused_distill_mse_grad": ("src/repro_torch/csrc/fused_losses.cu",
                               "src/repro/kernels/distill_loss.py:217"),
    "fused_distill_kl_grad": ("src/repro_torch/csrc/fused_losses.cu",
                              "src/repro/kernels/distill_loss.py:240"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:67"),
}
# the serving kernels (rows 1 to 4) whose launches a fleet run counts
ROWS_1_TO_4 = ("paged_attention_decode", "paged_attention_decode_quant",
               "paged_scatter", "paged_scatter_quant", "paged_gather")
# the paths each kernel belongs to (each must launch it where it ran)
PATHS = {"paged_scatter": ("fleet", "spec", "fleet_codist"),
         "paged_gather": ("fleet", "spec"),
         "paged_attention_decode": ("fleet", "spec", "fleet_codist"),
         "paged_attention_decode_quant": ("fleet", "spec"),
         "paged_scatter_quant": ("fleet", "spec"),
         "fused_cross_entropy": ("ops",), "flash_attention": ("ops",),
         "fused_cross_entropy_parts": ("train", "train_peers", "sweep",
                                       "async"),
         "fused_cross_entropy_grad": ("train", "train_peers", "sweep",
                                      "async"),
         "fused_ce_distill_parts": ("train", "train_peers", "sweep"),
         "fused_ce_distill_grad": ("train", "train_peers", "sweep"),
         "fused_distill_loss": ("train_peers", "sweep", "fleet_codist"),
         "fused_distill_kl_parts": ("train_peers", "async"),
         "fused_distill_mse_grad": ("train_peers", "sweep"),
         "fused_distill_kl_grad": ("train_peers", "async")}

# training main path (qwen1.5-0.5b, 2 peers, batch 8 x seq 512 per peer):
# T tokens per peer, padded vocab V
TRAIN_T, TRAIN_V = 4096, 152064
# the loss kernels' shapes: the main path's, a ragged fp32 one, the same
# with v_real < V, and a bf16 one whose rows are not 16-byte aligned, with
# the target a view off any 16-byte boundary (the all-scalar path)
LOSS_SHAPES = [("main", TRAIN_T, TRAIN_V, torch.bfloat16, 0),
               ("ragged", 37, 1000, torch.float32, 0),
               ("v_real<V", 37, 1000, torch.float32, 900),
               ("unaligned", 37, 700, torch.bfloat16, 0)]
# the distillation kernels also see the subsample wire's tokens: 8
# sequences x 64 of 512 (CodistConfig(subsample=64))
SUB_T = 8 * 64
# and the serving canary's: one prefill position's fp32 logits a pair
DISTILL_SHAPES = LOSS_SHAPES + [("subsample", SUB_T, TRAIN_V, torch.bfloat16, 0),
                                ("canary", 1, TRAIN_V, torch.float32, 0)]


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (NaN-safe)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# device-side spin queued before each timed call (~0.5 ms): the host has
# launched the call before its start event fires, so the event window holds
# device time and not the wrapper's Python and launch overhead
SPIN_CYCLES = 1_000_000


def time_ms(fn, flush: torch.Tensor, iters: int = 30, warmup: int = 3,
            clean: bool = False) -> float:
    """Mean device time of ``fn`` from CUDA events around each call, with
    the L2 cache flushed before every call (decode finds the pools cold:
    the layer's weights pass through L2 between two attention calls). The
    flush writes ``flush``, so the L2 it leaves holds dirty lines that the
    call's misses write back; ``clean`` flushes by reading it instead. A
    call that synchronises with the host inside (the plain decode) still
    counts the host time after its sync."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        if clean:
            flush.amax()
        else:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


# ----------------------------------------------------------------------------
# phase 1 / 2
# ----------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f"  torch {torch.__version__} cuda {torch.version.cuda}"
        f"  python {sys.version.split()[0]}")
    return line


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall")
    for name, r in info.items():
        regs = [int(w) for line in r["log"].splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = sum(int(w) for line in r["log"].splitlines()
                     for w, nxt in zip(line.split(), line.split()[1:])
                     if nxt == "bytes" and "spill" in line)
        log(f"  {name}: {r['seconds']:.1f} s{' (cached)' if r['cached'] else ''}"
            f"  max registers {max(regs) if regs else 'n/a'}"
            f"  spill bytes {spills}")
        _build.load(name)
    report_flash_build(info["flash_attention"]["log"])
    report_decode_build(info["paged_attention"]["log"])


FLASH_KERNELS = ("flash_wgmma_kernel", "flash_mma_kernel", "flash_kernel")


def flash_kernel_name(mangled: str) -> str:
    """'flash_mma_kernel<32>' for a mangled flash kernel name."""
    kind = next((k for k in FLASH_KERNELS if k in mangled), mangled)
    hd = re.search(r"Li(\d+)E", mangled)
    return f"{kind}<{hd.group(1) if hd else '?'}>"


def report_flash_build(nvcc_log: str) -> None:
    """Registers, spills and ptxas notes of each flash kernel (from a fresh
    build's ``-Xptxas -v``) and the tensor-core instructions in its SASS
    (``cuobjdump -sass``): the bf16 kernels must hold HGMMA (wgmma, hd 64
    and 128) or HMMA (mma.sync, hd 16 and 32)."""
    from repro_torch.kernels import _build
    fn = None
    for line in nvcc_log.splitlines():
        if "Compiling entry function" in line:
            fn = flash_kernel_name(line.split("'")[1])
        elif fn and any(w in line for w in ("Used", "spill", "Potential")):
            log(f"  {fn}: {line.split(':', 1)[-1].strip()}")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(_build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = flash_kernel_name(line.split("Function :")[1].strip())
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "HMMA" in line
    log("  flash SASS: " + ", ".join(f"{fn} HGMMA {hg} HMMA {hm}"
                                     for fn, (hg, hm) in sorted(counts.items())))
    for kind, hds, col in (("flash_wgmma_kernel", (64, 128), 0),
                           ("flash_mma_kernel", (16, 32), 1)):
        for hd in hds:
            require(counts.get(f"{kind}<{hd}>", [0, 0])[col] > 0,
                    f"{kind}<{hd}>: no tensor-core instruction in its SASS")


# pool types in the decode kernels' mangled names
DECODE_POOLS = {"f": "fp32", "13__nv_bfloat16": "bf16", "6__half": "fp16",
                "a": "int8", "13__nv_fp8_e4m3": "fp8"}


def report_decode_build(nvcc_log: str) -> None:
    """Registers and spills of each decode kernel instance (from a fresh
    build's ``-Xptxas -v``), one line per pool type; fails on a spill."""
    if not nvcc_log:
        log("  decode kernels: cached build, no ptxas log")
        return
    rows, fn, spill, spilled = {}, None, 0, []
    for line in nvcc_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            part = re.search(r"decode_partial_kernelI(\w+?)Li(\d+)ELi(\d+)E",
                             mangled)
            comb = re.search(r"decode_combine_kernelI(\w+?)EEv", mangled)
            fn = (("partial", DECODE_POOLS.get(part.group(1), part.group(1)),
                   f"hd {part.group(2)} GP {part.group(3)}") if part else
                  ("combine", "", "out " + DECODE_POOLS.get(comb.group(1),
                                                            comb.group(1)))
                  if comb else None)
        elif fn and "spill" in line:
            spill = sum(map(int, re.findall(r"(\d+) bytes spill", line)))
        elif fn and "Used" in line:
            regs = int(line.split("Used")[1].split()[0])
            rows.setdefault(fn[:2], []).append(f"{fn[2]} {regs} regs/{spill} B")
            if spill:
                spilled.append(" ".join(fn))
            fn = None
    for (kind, pool), insts in sorted(rows.items()):
        log(f"  decode_{kind}_kernel {pool} (registers/spill bytes): "
            + ", ".join(insts))
    require(rows, "no decode kernel in the ptxas log")
    require(not spilled, f"decode kernels spill: {spilled}")


# ----------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ----------------------------------------------------------------------------

def kernel_inputs(seed: int = 0):
    """Pools, table, lengths and a scatter map at the main-path shapes:
    slot 0 is inactive (length 0, all-zero table row); dead entries of a
    few slots point at the NaN-poisoned free block; the null block is 0."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(LENGTHS, np.int32)
    table = np.zeros((S, MB), np.int32)
    free = list(range(2, NB))
    for s in range(1, S):
        for m in range((lengths[s] + BS) // BS):
            table[s, m] = free.pop(0)
        n = (lengths[s] + BS) // BS
        if n < MB and s % 3 == 0:
            table[s, n:] = POISON
    k = rng.standard_normal((NB, BS, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((NB, BS, KVH, HD)).astype(np.float32)
    k[0] = v[0] = 0.0
    k[POISON] = v[POISON] = np.nan
    q = rng.standard_normal((S, H, HD)).astype(np.float32)
    new = rng.standard_normal((S, KVH, HD)).astype(np.float32)
    wslot = np.full((NB,), -1, np.int32)
    woff = np.zeros((NB,), np.int32)
    for s in range(1, S):           # slot 0 inactive: no map entry
        blk = table[s, lengths[s] // BS]
        wslot[blk], woff[blk] = s, lengths[s] % BS
    return dict(q=q, k=k, v=v, new=new, table=table, lengths=lengths,
                wslot=wslot, woff=woff)


def bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the scale of max|x| (8 significant bits)."""
    m = float(x.float().abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 2.0 ** -133


def bf16_misses(k: torch.Tensor, p: torch.Tensor, floor_rel: float = 2.0 ** -23,
                chunk: int = 1 << 25):
    """(count, worst ratio) of the elements of a bf16 output ``k`` farther
    from its plain version ``p`` than one bf16 ulp at the element's own
    magnitude plus a floor of ``floor_rel * max|p|``; the ratio is the
    largest |k - p| / (ulp + floor). Both sides round an fp32 value once,
    and the two fp32 values sum the same terms in other orders, so they
    differ by a few fp32 ulps of the largest partial sum: the floor covers
    that where the terms cancel towards 0. A dropped or wrong term fails
    wherever it is larger than the element's ulp. Compared ``chunk``
    elements at a time."""
    floor = floor_rel * float(p.float().abs().max())
    kv, pv = k.reshape(-1), p.reshape(-1)
    misses, worst = 0, 0.0
    for i in range(0, pv.numel(), chunk):
        pf, kf = pv[i:i + chunk].float(), kv[i:i + chunk].float()
        m, e = torch.frexp(pf.abs())
        ulp = torch.where(m > 0, torch.ldexp(torch.ones_like(m), e - 8),
                          torch.zeros_like(m))
        ratio = (kf - pf).abs() / (ulp + floor)
        misses += int((ratio > 1).sum())
        worst = max(worst, float(ratio.max()))
    return misses, worst


def bf16_grad_misses(k: torch.Tensor, p: torch.Tensor) -> int:
    """Elements of a bf16 gradient beyond one bf16 ulp of their own plus
    2^-23 max|p| (``bf16_misses``)."""
    return bf16_misses(k, p)[0]


# the decode's shapes (qwen2-7b, one layer's pools; label, slots, MB, NB,
# lengths): the fleet's (main), the fleet at 4k contexts (k2: 16 slots
# ragged to 4,095) and one request at qwen2-7b's full 32k window (k3)
DECODE_SHAPES = [("main", S, MB, NB, LENGTHS),
                 ("k2", 16, 256, 4097, [255 + 256 * i for i in range(16)]),
                 ("k3", 1, 2048, 2050, [32767])]
# held, not timed (label, slots, MB, NB, lengths, H, KVh, hd): qwen1.5-0.5b's
# heads (H = KVh = 16, hd = 64: G = 1, one warp per KV head), and G = 4 at hd
# 64 and G = 8 at hd 32, whose chunks take 2 and 1 steps; an inactive slot
# and a full table among them
DECODE_CHECKS = [("qwen1.5-0.5b", 4, 8, 16, [0, 5, 40, 127], 16, 16, 64),
                 ("hd64 G4", 3, 6, 12, [0, 17, 95], 8, 2, 64),
                 ("hd32 G8", 3, 6, 12, [0, 17, 95], 8, 1, 32)]


def decode_inputs(slots, mb, nb, lengths, dev: torch.device, seed: int,
                  h: int = H, kvh: int = KVH, hd: int = HD):
    """fp32 q and pools on the card for a decode shape with
    ``kernel_inputs``' table rule: disjoint live blocks from block 2 up,
    the dead entries of every third slot aimed at the NaN-poisoned block,
    the null block 0 all zero. Returns (q, k, v, table, lengths)."""
    lens = np.asarray(lengths, np.int32)
    table = np.zeros((slots, mb), np.int32)
    nxt = 2
    for s, ln in enumerate(lens):
        n = min((ln + BS) // BS, mb)
        if ln > 0:
            table[s, :n] = np.arange(nxt, nxt + n)
            nxt += n
        if n < mb and s % 3 == 0:
            table[s, n:] = POISON
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k, v = (torch.randn((nb, BS, kvh, hd), generator=gen, device=dev)
            for _ in range(2))
    for x in (k, v):
        x[0] = 0.0
        x[POISON] = float("nan")
    q = torch.randn((slots, h, hd), generator=gen, device=dev)
    return (q, k, v, torch.from_numpy(table).to(dev),
            torch.from_numpy(lens).to(dev))


def check_decode(what: str, o_k: torch.Tensor, o_p: torch.Tensor,
                 lengths: torch.Tensor, quantized: bool, faults: list) -> float:
    """A decode output against its plain version: finite, exactly 0 on the
    inactive slots (length 0); an fp32 output within 1e-5 (1e-5 max(|o|, 1)
    over quantized pools: the sums run in other orders, ~1e-7 relative); a
    bf16 output within one bf16 ulp at max|o| and, element by element,
    within one bf16 ulp of each element plus ``FLASH_FLOOR_REL`` max|o|, as
    flash attention's (both round an fp32 value once; the fp32 sums differ
    by a few fp32 ulps of max|o|). A failure goes into ``faults`` with the
    count of elements beyond the check, so that every shape is held before
    the phase fails. Returns max|kernel - plain|."""
    err = max_err(o_k, o_p)
    bad = []
    if not bool(torch.isfinite(o_k).all()):
        bad.append("non-finite output")
    if bool((o_k[lengths == 0] != 0).any()):
        bad.append("inactive slot output != 0")
    if o_k.dtype == torch.float32:
        tol = 1e-5 * (max(float(o_p.abs().max()), 1.0) if quantized else 1.0)
        n = int(((o_k - o_p).abs() > tol).sum())
        msg = f"max|kernel-plain| {err:.3e} (tol {tol:.3e})"
    else:
        tol = bf16_ulp(o_p)
        n, worst = bf16_misses(o_k, o_p, FLASH_FLOOR_REL)
        if err > tol:
            bad.append(f"max|kernel-plain| {err:.3e} > one bf16 ulp {tol:.3e}")
        msg = (f"max|kernel-plain| {err:.3e} (tol {tol:.3e}), {n} elements "
               f"beyond one bf16 ulp of their own (worst ratio {worst:.3f})")
    if n:
        bad.append(f"{n} elements beyond the check")
    log(f"  decode {what}: {msg}")
    if bad:
        faults.append(f"decode {what}: " + "; ".join(bad))
    return err


def decode_breakdown(fn, flush: torch.Tensor, n: int = 10) -> str:
    """Device time per call of each decode kernel (torch.profiler), with
    the L2 flushed before each call as in ``time_ms``."""
    parts = []
    for us, _count, key in kernel_times(lambda: (flush.zero_(), fn()), n):
        name = re.search(r"decode_\w+_kernel<[^>]*>", key)
        if name:
            parts.append(f"{name.group(0)} {us / n / 1e3:.4f} ms")
    return ", ".join(parts) or "not measured (no device time in the profile)"


def sdpa_on_gather(q, k, v, table, lengths):
    """SDPA over the gathered (S, H, MB*BS, hd) copy of the pools, the
    decode's library call (the gather is set-up, not timed)."""
    from repro_torch.kernels import paged_gather
    s, mb = table.shape
    n_live = ((lengths + BS) // BS).clamp(max=mb).to(torch.int32)
    kx, vx = (paged_gather(x, table, n_live).view(s, mb * BS, KVH, HD)
              .permute(0, 2, 1, 3).repeat_interleave(H // KVH, dim=1)
              .contiguous() for x in (k, v))
    mask = (torch.arange(mb * BS, device=q.device)[None, :]
            <= lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q4, kx, vx, attn_mask=mask)


def time_decode(what: str, q, kp, vp, table, lengths, scales, flush, lib,
                plain_iters: int = 30, plan_slots=None,
                byte_rows=None) -> dict:
    """Kernel, plain and library (``lib`` or None) times of the decode, its
    bound (each live K/V row, q and the output once, table and lengths;
    or 4 H hd operations per live position over the pool type's peak) and
    the kernel's time by its kernels. ``plan_slots`` fixes the kernel's
    split plan to that slot count's (the verify's) and the plain version's
    runs to the same length; ``byte_rows`` counts
    the K/V rows the bytes bound reads once where slots share them (the
    verify's pseudo-slots)."""
    from repro_torch.kernels import (paged_attention_decode,
                                     paged_attention_decode_plain)
    from repro_torch.kernels.paged_attention import (_num_sms,
                                                     decode_split_plan)
    bps = None if plan_slots is None else decode_split_plan(
        plan_slots, table.shape[1], _num_sms(torch.cuda.current_device()))[0]
    rows = int((lengths.long() + 1).sum())
    row_b = KVH * HD * kp.element_size() + (4 if scales else 0)
    nbytes = (2 * (byte_rows or rows) * row_b + 2 * q.numel() * q.element_size()
              + table.numel() * 4 + lengths.numel() * 4)
    tb = nbytes / HBM_BPS * 1e3
    tf = 4 * H * HD * rows / PEAK_FLOPS[kp.dtype] * 1e3

    sc = scales or (None, None)

    def kern():
        return paged_attention_decode(q, kp, vp, table, lengths, *sc,
                                      plan_slots=plan_slots)

    r = {"ms": time_ms(kern, flush),
         "plain_ms": time_ms(lambda: paged_attention_decode_plain(
             q, kp, vp, table, lengths, *sc, bps), flush,
             iters=plain_iters, warmup=min(3, plain_iters)),
         "library_ms": None if lib is None else time_ms(lib, flush),
         "bound_ms": max(tb, tf), "bound_by": "bytes" if tb >= tf else "operations"}
    lib_txt = ("— (no single call)" if lib is None
               else f"{r['library_ms']:.4f} ms (SDPA on the gathered copy)")
    # the floor of time_ms's flushed L2: one amax over each pool's live
    # blocks (contiguous from block 2 in both input builders), read as int32
    live = int(((lengths.long() + BS) // BS).clamp(max=table.shape[1]).sum())
    kw, vw = (x.view(torch.int32)[2:2 + live] for x in (kp, vp))

    def floor():
        return kw.amax(), vw.amax()

    log(f"  {what}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
        f"library {lib_txt}  bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
        f"{r['bound_ms'] / r['ms']:.1%} of it; {rows} positions; floor "
        f"(amax over the live blocks of K and of V) "
        f"{time_ms(floor, flush):.4f} ms; by kernel: "
        f"{decode_breakdown(kern, flush)}; L2 flushed by a read: kernel "
        f"{time_ms(kern, flush, clean=True):.4f} ms, floor "
        f"{time_ms(floor, flush, clean=True):.4f} ms")
    return r


def phase_kernels(dev: torch.device, flush: torch.Tensor):
    from repro_torch.kernels import (paged_attention_decode,
                                     paged_attention_decode_plain,
                                     paged_gather, paged_gather_plain,
                                     paged_scatter_kv, paged_scatter_kv_plain)
    inp = kernel_inputs()
    t = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}
    lengths, table = t["lengths"], t["table"]
    n_live = ((lengths + BS) // BS).to(torch.int32)
    results, faults = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        es = torch.tensor([], dtype=dtype).element_size()
        k, v, q, new = (t[x].to(dtype) for x in ("k", "v", "q", "new"))

        # the fleet's map into both pools: bit-exact, null block stays 0,
        # poisoned block untouched (all three pool sizes: the scatter phase)
        kk, vv = paged_scatter_kv(k.clone(), v.clone(), new, new, t["wslot"],
                                  t["woff"])
        kp, vp = paged_scatter_kv_plain(k.clone(), v.clone(), new, new,
                                        t["wslot"], t["woff"])
        sync(dev)
        scatter_faults(f"paged_scatter_kv main {name} (the fleet's map)",
                       [(kk, kp, k), (vv, vp, v)], faults)

        # gather: bit-exact (zeros past n_live, poison never read)
        g_k = paged_gather(kk, table, n_live)
        g_p = paged_gather_plain(kk, table, n_live)
        sync(dev)
        require(bits_equal(g_k, g_p), f"paged_gather {name}: kernel != plain")
        require(not torch.isnan(g_k).any(), f"paged_gather {name}: read poison")
        log(f"kernels {name}: scatter checked, gather bit-exact")

        # decode attention: fp32 state in both (check_decode's tolerances)
        err = check_decode(
            f"main {name}", paged_attention_decode(q, kk, vv, table, lengths),
            paged_attention_decode_plain(q, kk, vv, table, lengths), lengths,
            False, faults)
        if dtype != torch.bfloat16:
            continue

        # ---- times at the main-path dtype (bf16) ----
        flat_table = table.reshape(-1).long()
        block_b = BS * KVH * HD * es
        live_blocks = int(n_live.sum())
        bytes_gather = (live_blocks * block_b + S * MB * block_b
                        + table.numel() * 4 + S * 4)
        gather = (lambda: paged_gather(kk, table, n_live),
                  lambda: paged_gather_plain(kk, table, n_live),
                  lambda: kk.index_select(0, flat_table))
        r = results["paged_gather"] = {
            "ms": time_ms(gather[0], flush), "plain_ms": time_ms(gather[1], flush),
            "library_ms": time_ms(gather[2], flush),
            "bound_ms": bytes_gather / HBM_BPS * 1e3, "bound_by": "bytes",
            "max_abs_err": 0.0}
        log(f"  paged_gather bf16: kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  "
            f"bound {r['bound_ms']:.5f} ms (bytes)")
        results["paged_attention_decode"] = dict(
            time_decode("paged_attention_decode main bf16", q, kk, vv, table,
                        lengths, (), flush,
                        sdpa_on_gather(q, kk, vv, table, lengths)),
            max_abs_err=err)
        # row 3's floor: the gather's output written alone (a memset) after
        # the same L2 flush, and the gather and index_select with no flush
        out = torch.empty_like(g_k)
        no_flush = torch.empty(0, device=dev)
        log(f"  paged_gather floor: memset of its {out.numel() * es / 1e6:.1f}"
            f" MB output {time_ms(out.zero_, flush):.4f} ms; with no L2 "
            f"flush: kernel {time_ms(gather[0], no_flush):.4f} ms, "
            f"index_select {time_ms(gather[2], no_flush):.4f} ms")

    # the decode at the fleet's 4k contexts and at one 32k request
    for si, (label, slots, mb, nb, lens) in enumerate(DECODE_SHAPES[1:]):
        q, k, v, table, lengths = decode_inputs(slots, mb, nb, lens, dev,
                                                600 + si)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            check_decode(f"{label} {str(dtype)[6:]}",
                         paged_attention_decode(qd, kd, vd, table, lengths),
                         paged_attention_decode_plain(qd, kd, vd, table,
                                                      lengths),
                         lengths, False, faults)
        time_decode(f"paged_attention_decode {label} bf16 (S={slots}, "
                    f"MB={mb})", qd, kd, vd, table, lengths, (), flush,
                    sdpa_on_gather(qd, kd, vd, table, lengths), plain_iters=3)
        del q, k, v, qd, kd, vd
        torch.cuda.empty_cache()
    for label, slots, mb, nb, lens, h, kvh, hd in DECODE_CHECKS:
        q, k, v, table, lengths = decode_inputs(slots, mb, nb, lens, dev, 610,
                                                h, kvh, hd)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            check_decode(f"{label} {str(dtype)[6:]}",
                         paged_attention_decode(qd, kd, vd, table, lengths),
                         paged_attention_decode_plain(qd, kd, vd, table,
                                                      lengths),
                         lengths, False, faults)
    require(not faults, "; ".join(faults))
    return results


def quantized_pools(k: torch.Tensor, v: torch.Tensor, dtype):
    """fp32 K and V pools quantized to ``dtype`` on the card, each with its
    (NB, BS) scales: the null block 0 and scale 0, the poisoned block with
    NaN scales (and NaN fp8 rows)."""
    from repro_torch.kernels import quantize_rows
    out = []
    for full in (k, v):
        full = full.clone()
        full[POISON] = 0.0
        q, sc = quantize_rows(full, dtype)
        sc[POISON] = float("nan")
        if dtype == torch.float8_e4m3fn:
            q.view(torch.uint8)[POISON] = 0x7F           # e4m3fn NaN
        out += [q.contiguous(), sc.contiguous()]
    return out


def phase_quant_kernels(dev: torch.device, flush: torch.Tensor):
    """Rows 1q (and 4, 3) over int8 and fp8 pools: the K+V quantizing
    scatter of the fleet's bf16 rows on the fleet's map bit-exact against
    its plain version (poisoned and null blocks untouched; the scatter's
    other checks and its times are ``phase_scatter_kernels``'), the gather
    (row 3) of an int8 pool and of its scales bit-exact, the dequantizing
    decode against its plain version with fp32 q (1e-5 of the output's
    scale) and bf16 q (``check_decode``) at the main-path shapes, k2 and k3;
    decode times with bf16 q. Returns the int8 decode row at the main path;
    the fp8 times are printed."""
    from repro_torch.kernels import (paged_attention_decode,
                                     paged_attention_decode_plain,
                                     paged_gather, paged_gather_plain,
                                     paged_scatter_quant_kv,
                                     paged_scatter_quant_kv_plain)
    inp = kernel_inputs()
    t = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}
    lengths, table, ws, wo = t["lengths"], t["table"], t["wslot"], t["woff"]
    results, faults = {}, []
    for qdt in QUANT:
        name = "int8" if qdt == torch.int8 else "fp8"
        kq, ks, vq, vs = quantized_pools(t["k"], t["v"], qdt)
        # the fleet's map and rows (bf16) into both pools: bit-exact, null
        # and poisoned blocks untouched (all three pool sizes and fp32 rows:
        # the scatter phase)
        new = t["new"].to(torch.bfloat16)
        want = paged_scatter_quant_kv_plain(
            *(x.clone() for x in (kq, ks, vq, vs)), new, new, ws, wo)
        before = (kq.clone(), ks.clone(), vq.clone(), vs.clone())
        paged_scatter_quant_kv(kq, ks, vq, vs, new, new, ws, wo)
        sync(dev)
        scatter_faults(f"paged_scatter_quant_kv main {name} (the fleet's map)",
                       list(zip((kq, ks, vq, vs), want, before)), faults)
        del want, before
        # the gather path's copies of an int8 pool and of its scales (the
        # fleet's gather tick): bit-exact, zeros past n_live, the
        # NaN-scaled block never read
        n_live = ((lengths + BS) // BS).to(torch.int32)
        for pool in ((kq, ks[..., None, None]) if qdt == torch.int8 else ()):
            g_k = paged_gather(pool, table, n_live)
            g_p = paged_gather_plain(pool, table, n_live)
            sync(dev)
            require(bits_equal(g_k, g_p), f"paged_gather {name}: kernel != plain")
            require(not bool(torch.isnan(g_k.float()).any()),
                    f"paged_gather {name}: read poison")
        log(f"kernels {name} pools: scatter_quant_kv checked"
            f"{'; gather of the pool and its scales bit-exact' if qdt == torch.int8 else ''}")
        for qd in (torch.float32, torch.bfloat16):
            q = t["q"].to(qd)
            err = check_decode(
                f"main {name}, {str(qd)[6:]} q",
                paged_attention_decode(q, kq, vq, table, lengths, ks, vs),
                paged_attention_decode_plain(q, kq, vq, table, lengths, ks,
                                             vs), lengths, True, faults)

        # ---- times at the main path's types (bf16 q) ----
        r = dict(time_decode(
            f"paged_attention_decode_quant main {name} (bf16 q)", q, kq, vq,
            table, lengths, (ks, vs), flush, None), max_abs_err=err)
        if qdt == torch.int8:
            results["paged_attention_decode_quant"] = r

    # the decode at the fleet's 4k contexts and at one 32k request
    for si, (label, slots, mb, nb, lens) in enumerate(DECODE_SHAPES[1:]):
        q, k, v, table, lengths = decode_inputs(slots, mb, nb, lens, dev,
                                                600 + si)
        for qdt in QUANT:
            name = "int8" if qdt == torch.int8 else "fp8"
            kq, ks, vq, vs = quantized_pools(k, v, qdt)
            for qd in (torch.float32, torch.bfloat16):
                qq = q.to(qd)
                check_decode(
                    f"{label} {name}, {str(qd)[6:]} q",
                    paged_attention_decode(qq, kq, vq, table, lengths, ks, vs),
                    paged_attention_decode_plain(qq, kq, vq, table, lengths,
                                                 ks, vs),
                    lengths, True, faults)
            time_decode(f"paged_attention_decode_quant {label} {name} (bf16 "
                        f"q, S={slots}, MB={mb})", qq, kq, vq, table, lengths,
                        (ks, vs), flush, None, plain_iters=3)
            del kq, ks, vq, vs
        del q, k, v
        torch.cuda.empty_cache()
    for label, slots, mb, nb, lens, h, kvh, hd in DECODE_CHECKS:
        q, k, v, table, lengths = decode_inputs(slots, mb, nb, lens, dev, 610,
                                                h, kvh, hd)
        for qdt in QUANT:
            kq, ks, vq, vs = quantized_pools(k, v, qdt)
            for qd in (torch.float32, torch.bfloat16):
                qq = q.to(qd)
                check_decode(
                    f"{label} {str(qdt)[6:]}, {str(qd)[6:]} q",
                    paged_attention_decode(qq, kq, vq, table, lengths, ks, vs),
                    paged_attention_decode_plain(qq, kq, vq, table, lengths,
                                                 ks, vs),
                    lengths, True, faults)
    require(not faults, "; ".join(faults))
    return results


# the scatters' pool sizes at the qwen2-7b row (S = 16 slots, 15 writers):
# the fleet's pool (main), the decode's 4k shape (k2) and a 2-peer fleet's
# pool on one card (full: ~15 GB of bf16 KV a peer)
def phase_verify_kernels(dev: torch.device, flush: torch.Tensor) -> dict:
    """Row 1 (and 1q) at the speculative verify's shape: the fleet's 16
    slots times k = 4 pseudo-slots, each slot's table row repeated k times
    at lengths L..L+3, the split plan fixed to the plain 16-slot tick's.
    Each output is held against the plain version at the same
    ``blocks_per_split`` (``check_decode``), and pseudo-slot (s, j) must
    equal, bit for bit, the 16-slot decode of slot s at length L+j (the
    reason for the fixed plan); bf16 and fp32 q over bf16 / fp32 pools,
    bf16 q over int8 / fp8. Prints the verify launch's time at the fixed
    and at its own plan against the 16-slot launch, SDPA on the gathered
    copy and its bound. Returns the bf16 times."""
    from repro_torch.kernels import (paged_attention_decode,
                                     paged_attention_decode_plain)
    from repro_torch.kernels.paged_attention import (_num_sms,
                                                     decode_split_plan)
    k = SPEC_K
    # each slot's blocks cover L+3 (as a verify's reservation does)
    top = [0 if n == 0 else min(n, MB * BS - k) + k - 1 for n in LENGTHS]
    q, kf, vf, table, lmax = decode_inputs(S, MB, NB, top, dev, 620)
    base = torch.clamp(lmax - (k - 1), min=0).to(torch.int32)
    table_x = table.repeat_interleave(k, dim=0).contiguous()
    len_x = (base[:, None] + torch.arange(k, device=dev,
                                          dtype=torch.int32)).reshape(-1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(621)
    qx = torch.randn((S * k, H, HD), generator=gen, device=dev)
    bps = decode_split_plan(S, MB, _num_sms(torch.cuda.current_device()))[0]
    own = decode_split_plan(S * k, MB, _num_sms(torch.cuda.current_device()))
    log(f"kernels verify: S*k = {S * k} pseudo-slots, the plain tick's plan "
        f"{bps} blocks a run (the S*k launch's own: {own[0]})")
    faults, out = [], {}
    pools = [(torch.float32, torch.float32, kf, vf, ()),
             (torch.bfloat16, torch.bfloat16, kf, vf, ())]
    for qdt in QUANT:
        kq, ks, vq, vs = quantized_pools(kf, vf, qdt)
        pools.append((torch.bfloat16, qdt, kq, vq, (ks, vs)))
    for q_dt, pool_dt, kp, vp, scales in pools:
        quant = bool(scales)
        kd = kp if quant else kp.to(pool_dt)
        vd = vp if quant else vp.to(pool_dt)
        qd = qx.to(q_dt)
        sc = scales or (None, None)
        what = f"verify {str(pool_dt)[6:]} pools, {str(q_dt)[6:]} q"
        o_k = paged_attention_decode(qd, kd, vd, table_x, len_x, *sc,
                                     plan_slots=S)
        check_decode(what, o_k, paged_attention_decode_plain(
            qd, kd, vd, table_x, len_x, *sc, bps), len_x, quant, faults)
        for j in range(k):
            o_s = paged_attention_decode(qd[j::k].contiguous(), kd, vd, table,
                                         (base + j).to(torch.int32), *sc)
            if not bits_equal(o_k[j::k], o_s):
                faults.append(f"{what}: pseudo-slots j={j} differ from the "
                              f"{S}-slot decode at L+{j}")
        if q_dt == torch.bfloat16 and pool_dt == torch.bfloat16:
            out = time_decode(f"paged_attention_decode verify bf16 (S*k={S * k},"
                              f" plan {bps})", qd, kd, vd, table_x, len_x, (),
                              flush, sdpa_on_gather(qd, kd, vd, table_x, len_x),
                              plan_slots=S,
                              byte_rows=int((lmax.long() + 1).sum()))
            own_ms = time_ms(lambda: paged_attention_decode(
                qd, kd, vd, table_x, len_x), flush)
            s_ms = time_ms(lambda: paged_attention_decode(
                qd[::k].contiguous(), kd, vd, table, base), flush)
            log(f"  verify bf16: the S*k launch at its own plan "
                f"{own_ms:.4f} ms, the {S}-slot launch at L {s_ms:.4f} ms "
                f"({k} of them {k * s_ms:.4f} ms)")
            out.update(own_ms=own_ms, s_ms=s_ms)
    require(not faults, "; ".join(faults))
    log(f"kernels verify: every output held, pseudo-slots bit-equal to the "
        f"{S}-slot decodes")
    return out


SCATTER_NBS = [("main", NB), ("k2", 4097), ("full", 16385)]


def scatter_inputs(nb: int, dev: torch.device, seed: int):
    """fp32 K and V pools (NB, BS, KVh, hd) made on the card from a seeded
    generator (null block 0 zero, the poisoned block NaN), S fp32 rows each
    for K and V, and write maps with 15 writers (slot 0 inactive): slots
    1..7 in blocks 4 s + 2 (one 4-entry column of the map, so one ballot
    holds all seven), 8..14 in random blocks, 15 in block NB - 1; offsets 0
    (slot 1) and BS - 1 (slots 2 and 15) among them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k, v = (torch.randn((nb, BS, KVH, HD), generator=gen, device=dev)
            for _ in range(2))
    for x in (k, v):
        x[0] = 0.0
        x[POISON] = float("nan")
    k_new, v_new = (torch.randn((S, KVH, HD), generator=gen, device=dev)
                    for _ in range(2))
    cpu = torch.Generator()
    cpu.manual_seed(seed)
    blocks = [4 * s + 2 for s in range(1, 8)]
    blocks += (32 + torch.randperm(nb - 33, generator=cpu)[:7]).tolist()
    blocks.append(nb - 1)
    offs = torch.randint(0, BS, (S,), generator=cpu).tolist()
    offs[1], offs[2], offs[15] = 0, BS - 1, BS - 1
    ws = torch.full((nb,), -1, dtype=torch.int32)
    wo = torch.zeros((nb,), dtype=torch.int32)
    for s, b in enumerate(blocks, start=1):
        ws[b], wo[b] = s, offs[s]
    return k, v, k_new, v_new, ws.to(dev), wo.to(dev)


def random_quant_pool(nb: int, dtype, dev: torch.device, gen):
    """A quantized pool of random bytes and its random fp32 scales: the null
    block 0 and scale 0, the poisoned block NaN scales (and NaN fp8 rows)."""
    q = torch.randint(-128, 128, (nb, BS, KVH, HD), generator=gen, device=dev,
                      dtype=torch.int8).view(dtype)
    sc = torch.rand((nb, BS), generator=gen, device=dev)
    q.view(torch.uint8)[0] = 0
    sc[0] = 0.0
    sc[POISON] = float("nan")
    if dtype == torch.float8_e4m3fn:
        q.view(torch.uint8)[POISON] = 0x7F                # e4m3fn NaN
    return q, sc


def scatter_faults(what: str, pairs, faults) -> None:
    """Each (kernel's pool, plain version's pool, pool before) bit for bit:
    the kernel's equal to the plain version's, its null block all zero and
    its poisoned block as before. A failure is collected in ``faults``."""
    for i, (got, want, before) in enumerate(pairs):
        bad = [msg for ok, msg in (
            (bits_equal(got, want), "kernel != plain"),
            (not bool(got[0].view(torch.uint8).any()), "null block written"),
            (bits_equal(got[POISON], before[POISON]), "poisoned block written"))
            if not ok]
        if bad:
            faults.append(f"{what} [{i}]: {', '.join(bad)}")


def off16(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of ``x`` whose storage starts one element past a
    fresh allocation, so off a 16-byte boundary."""
    out = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
    return out.view(x.shape).copy_(x)


def host_us(fn, n: int = 1000) -> float:
    """Host time of one call of ``fn``: the mean over ``n`` back-to-back
    calls, one synchronise at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def phase_scatter_kernels(dev: torch.device, flush: torch.Tensor):
    """Rows 2 and 4 at the three pool sizes of ``SCATTER_NBS``: the K+V and
    the single-pool scatters bit-exact against their plain versions over
    fp32 and bf16 pools and over int8 and fp8 pools from fp32 and bf16 rows
    (null block and poisoned block untouched, a writer in block NB - 1);
    then, at the fleet's types (bf16 rows into bf16 / int8 / fp8 pools),
    the times of the K+V launch, of one single-pool launch and of two (K,
    then V), of the plain version, of two ``index_put_`` calls, of the
    launch floor (a one-CTA ``zero_``), the bound and the host time of one
    wrapper call. A failing check is collected and the phase fails at its
    end with every failing NB. Returns rows 2 and 4 (the K+V launch) at
    main."""
    from repro_torch.kernels import (paged_scatter, paged_scatter_kv,
                                     paged_scatter_kv_plain,
                                     paged_scatter_quant,
                                     paged_scatter_quant_kv,
                                     paged_scatter_quant_kv_plain)
    results, faults = {}, []
    floor_buf = torch.zeros(1, device=dev)
    for si, (label, nb) in enumerate(SCATTER_NBS):
        k, v, k_new, v_new, ws, wo = scatter_inputs(nb, dev, 700 + si)
        writers = int((ws >= 0).sum())
        blk = torch.nonzero(ws >= 0).flatten()
        off = wo[blk].long()
        src = ws[blk].long()
        for dtype in (torch.float32, torch.bfloat16):
            kd, vd, kn, vn = (x.to(dtype) for x in (k, v, k_new, v_new))
            name = f"{label} {str(dtype)[6:]}"
            got = (kd.clone(), vd.clone())
            want = (kd.clone(), vd.clone())
            paged_scatter_kv(*got, kn, vn, ws, wo)
            paged_scatter_kv_plain(*want, kn, vn, ws, wo)
            one = kd.clone()
            paged_scatter(one, kn, ws, wo)
            sync(dev)
            scatter_faults(f"paged_scatter_kv {name}",
                           [(got[0], want[0], kd), (got[1], want[1], vd)],
                           faults)
            scatter_faults(f"paged_scatter {name}", [(one, want[0], kd)],
                           faults)
            del kd, vd, got, want, one
        gen = torch.Generator(device=dev)
        gen.manual_seed(710 + si)
        qpools = {qdt: (*random_quant_pool(nb, qdt, dev, gen),
                        *random_quant_pool(nb, qdt, dev, gen)) for qdt in QUANT}
        for qdt, (kq, ks, vq, vs) in qpools.items():
            for rdt in (torch.float32, torch.bfloat16):
                kn, vn = k_new.to(rdt), v_new.to(rdt)
                name = f"{label} {str(qdt)[6:]} from {str(rdt)[6:]} rows"
                got = [x.clone() for x in (kq, ks, vq, vs)]
                want = [x.clone() for x in (kq, ks, vq, vs)]
                paged_scatter_quant_kv(*got, kn, vn, ws, wo)
                paged_scatter_quant_kv_plain(*want, kn, vn, ws, wo)
                one = [kq.clone(), ks.clone()]
                paged_scatter_quant(*one, kn, ws, wo)
                sync(dev)
                scatter_faults(f"paged_scatter_quant_kv {name}", list(zip(
                    got, want, (kq, ks, vq, vs))), faults)
                scatter_faults(f"paged_scatter_quant {name}", list(zip(
                    one, want[:2], (kq, ks))), faults)
                del got, want, one
        # bf16 rows and both maps off a 16-byte boundary: the copy in 2-byte
        # units, the quantizing scatter one element a unit, the maps read
        # one entry at a time
        kn, vn, ws_u, wo_u = (off16(x, dev) for x in (
            k_new.to(torch.bfloat16), v_new.to(torch.bfloat16), ws, wo))
        kd, vd = k.to(torch.bfloat16), v.to(torch.bfloat16)
        got, want = (kd.clone(), vd.clone()), (kd.clone(), vd.clone())
        paged_scatter_kv(*got, kn, vn, ws_u, wo_u)
        paged_scatter_kv_plain(*want, kn, vn, ws, wo)
        sync(dev)
        scatter_faults(f"paged_scatter_kv {label} bfloat16 unaligned",
                       [(got[0], want[0], kd), (got[1], want[1], vd)], faults)
        del kd, vd, got, want
        for qdt, pools in qpools.items():
            got = [x.clone() for x in pools]
            want = [x.clone() for x in pools]
            paged_scatter_quant_kv(*got, kn, vn, ws_u, wo_u)
            paged_scatter_quant_kv_plain(*want, kn, vn, ws, wo)
            sync(dev)
            scatter_faults(f"paged_scatter_quant_kv {label} {str(qdt)[6:]} "
                           "unaligned", list(zip(got, want, pools)), faults)
            del got, want
        log(f"kernels scatter {label} (NB={nb}, {writers} writers): K+V and "
            "single-pool checks done, aligned and not")

        # ---- times at the fleet's types: bf16 rows into bf16 / int8 / fp8 ----
        kb, vb, kn, vn = (x.to(torch.bfloat16) for x in (k, v, k_new, v_new))
        del k, v
        row_b = KVH * HD * 2
        kr, vr = kn[src], vn[src]
        floor = time_ms(floor_buf.zero_, flush)
        lines = [f"  scatter {label} (NB={nb}): launch floor (one-CTA zero_) "
                 f"{floor:.4f} ms"]

        def timed(row, kv, one, plain, lib, nbytes):
            r = {"ms": time_ms(kv, flush), "one_ms": time_ms(one, flush),
                 "two_ms": time_ms(lambda: (one(), one()), flush),
                 "plain_ms": time_ms(plain, flush, iters=10),
                 "library_ms": None if lib is None else time_ms(lib, flush),
                 "bound_ms": nbytes / HBM_BPS * 1e3, "bound_by": "bytes",
                 "max_abs_err": 0.0, "floor_ms": floor}
            # host time, three times each in turns; the medians are kept
            hk, ho = [], []
            for _ in range(3):
                hk.append(host_us(kv))
                ho.append(host_us(one))
            r["host_us"], r["host_one_us"] = sorted(hk)[1], sorted(ho)[1]
            lib_txt = ("— (no single call)" if lib is None
                       else f"{r['library_ms']:.4f} ms")
            lines.append(
                f"  {row}: K+V kernel {r['ms']:.4f} ms (one pool "
                f"{r['one_ms']:.4f}, two single-pool launches "
                f"{r['two_ms']:.4f})  plain {r['plain_ms']:.4f} ms  two "
                f"index_put_ {lib_txt}  bound {r['bound_ms']:.7f} ms (bytes);"
                f" K+V - floor {r['ms'] - floor:.4f} ms; host (median of 3 x "
                f"1000 calls) {r['host_us']:.1f} us a K+V call "
                f"({', '.join(f'{x:.1f}' for x in hk)}), {r['host_one_us']:.1f}"
                f" us a single-pool call ({', '.join(f'{x:.1f}' for x in ho)})"
                f", ratio {r['host_us'] / r['host_one_us']:.2f}")
            return r

        r2 = timed(
            "paged_scatter bf16",
            lambda: paged_scatter_kv(kb, vb, kn, vn, ws, wo),
            lambda: paged_scatter(kb, kn, ws, wo),
            lambda: paged_scatter_kv_plain(kb, vb, kn, vn, ws, wo),
            lambda: (kb.index_put_((blk, off), kr),
                     vb.index_put_((blk, off), vr)),
            4 * writers * row_b + 2 * nb * 4)
        r4 = {}
        for qdt, (kq, ks, vq, vs) in qpools.items():
            qrow_b = KVH * HD * qdt.itemsize + 4       # payload + scale
            r4[qdt] = timed(
                f"paged_scatter_quant {str(qdt)[6:]} (bf16 rows)",
                lambda: paged_scatter_quant_kv(kq, ks, vq, vs, kn, vn, ws, wo),
                lambda: paged_scatter_quant(kq, ks, kn, ws, wo),
                lambda: paged_scatter_quant_kv_plain(kq, ks, vq, vs, kn, vn,
                                                     ws, wo),
                None, 2 * writers * (row_b + qrow_b) + 2 * nb * 4)
        log("\n".join(lines))
        if label == "main":
            results["paged_scatter"] = r2
            results["paged_scatter_quant"] = r4[torch.int8]
        del kb, vb, qpools
        torch.cuda.empty_cache()
    require(not faults, f"{len(faults)} scatter checks failed: "
            + "; ".join(faults))
    return results


# the standalone flash attention's shapes: (label, B, S, T, H, KVh, hd,
# causal, window, dtype); a-c are timed (qwen1.5-0.5b training attention,
# qwen2-7b prefill at 4k, the same with a 1024 window), d-i are checks
# (ragged, non-causal T != S, rows masked in every column, a window
# without causal, and a window that skips whole tiles, causal and not),
# held in fp32 and, as their bf16 twins (listed last, so that every
# shape keeps its seed, 500 + its index), through the tensor-core kernels
# (hd 64 and 128 on wgmma, hd 16 and 32 on mma.sync); "unaligned" views
# q, k and v off any 16-byte boundary (the wrapper copies them aligned);
# f's twins at hd 64 and 128 walk every column of the rows masked in every
# column (S > T) on wgmma
FLASH_SHAPES = [
    ("a", 8, 512, 512, 16, 16, 64, True, 0, torch.bfloat16),
    ("b", 1, 4096, 4096, 28, 4, 128, True, 0, torch.bfloat16),
    ("c", 1, 4096, 4096, 28, 4, 128, True, 1024, torch.bfloat16),
    ("d", 2, 100, 100, 6, 2, 64, True, 0, torch.float32),
    ("e", 2, 96, 200, 8, 2, 128, False, 0, torch.float32),
    ("e bf16", 2, 96, 200, 8, 2, 128, False, 0, torch.bfloat16),
    ("f", 1, 200, 64, 4, 2, 32, True, 16, torch.float32),
    ("g", 1, 128, 128, 4, 4, 16, False, 24, torch.float32),
    ("h", 1, 512, 512, 4, 2, 64, True, 100, torch.float32),
    ("i", 1, 512, 512, 4, 2, 64, False, 100, torch.float32),
    ("d bf16", 2, 100, 100, 6, 2, 64, True, 0, torch.bfloat16),
    ("e bf16 unaligned", 2, 96, 200, 8, 2, 128, False, 0, torch.bfloat16),
    ("f bf16", 1, 200, 64, 4, 2, 32, True, 16, torch.bfloat16),
    ("g bf16", 1, 128, 128, 4, 4, 16, False, 24, torch.bfloat16),
    ("h bf16", 1, 512, 512, 4, 2, 64, True, 100, torch.bfloat16),
    ("i bf16", 1, 512, 512, 4, 2, 64, False, 100, torch.bfloat16),
    ("f bf16 hd64", 1, 200, 64, 4, 2, 64, True, 16, torch.bfloat16),
    ("f bf16 hd128", 1, 200, 64, 4, 2, 128, True, 16, torch.bfloat16),
]
TIMED_FLASH = ("a", "b", "c")
# the standalone CE's shapes: the training main path's, ragged fp32, and
# bf16 rows off any 16-byte boundary
CE_SHAPES = [("main", TRAIN_T, TRAIN_V, torch.bfloat16),
             ("ragged", 37, 1000, torch.float32),
             ("unaligned", 37, 700, torch.bfloat16)]


def flash_inputs(b, s, t, h, kvh, hd, dtype, dev: torch.device, seed: int,
                 unaligned: bool = False):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = [torch.randn(shape, generator=gen, device=dev).to(dtype)
           for shape in ((b, s, h, hd), (b, t, kvh, hd), (b, t, kvh, hd))]
    if unaligned:            # contiguous views one element past a boundary
        for i, x in enumerate(out):
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
            buf[1:].copy_(x.reshape(-1))
            out[i] = buf[1:].view(x.shape)
    return out


def flash_bound(b, s, t, h, kvh, hd, causal, window, dtype, dev):
    """(bound ms, bytes or operations): q, k, v read once and the output
    written once, or 4 hd FLOP per kept (row, column) pair and head over
    the peak of the inputs' type."""
    from repro_torch.kernels.flash_attention import attention_mask
    es = torch.tensor([], dtype=dtype).element_size()
    pairs = int(attention_mask(s, t, causal, window, dev).sum())
    tb = (2 * b * s * h * hd + 2 * b * t * kvh * hd) * es / HBM_BPS * 1e3
    tf = 4 * hd * pairs * h * b / PEAK_FLOPS[dtype] * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


# the bf16 flash check's floor, relative to max|out|: the kernel and the
# plain version sum up to T products p * v (|p * v| <= max|v|, weights
# summing to 1) in other orders, a few fp32 ulps of max|out| apart
FLASH_FLOOR_REL = 2.0 ** -16


def check_flash(label, o_k, o_p, dtype) -> float:
    """fp32 within 1e-4 (the reference's tolerance); bf16 element by
    element, within one bf16 ulp of the element plus ``FLASH_FLOOR_REL *
    max|out|`` (both round an fp32 value once, the sums run in other
    orders). Returns max|kernel - plain|."""
    err = max_err(o_k, o_p)
    require(bool(torch.isfinite(o_k).all()), f"flash {label}: non-finite")
    if dtype == torch.float32:
        require(err <= 1e-4, f"flash {label}: max|kernel-plain| {err:.3e} "
                f"> 1e-4")
        return err
    bad, worst = bf16_misses(o_k, o_p, FLASH_FLOOR_REL)
    log(f"  flash {label} bf16: worst |kernel-plain| / (element ulp + "
        f"floor) = {worst:.3f}")
    require(bad == 0, f"flash {label}: {bad} elements beyond one bf16 ulp "
            f"of their own plus 2^-16 max|out| (max|kernel-plain| "
            f"{err:.3e})")
    return err


def phase_ops_kernels(dev: torch.device, flush: torch.Tensor):
    """Rows 5 and 14, the standalone forward CE and flash attention,
    against their plain versions at CE_SHAPES and FLASH_SHAPES, with
    times at the main CE shape and flash shapes a-c (the JSON row: b)."""
    import torch.nn.functional as F

    from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                     fused_cross_entropy,
                                     fused_cross_entropy_plain)
    from repro_torch.kernels.flash_attention import attention_mask
    results = {}
    for si, (label, t, v, dtype) in enumerate(CE_SHAPES):
        x, _tg, lb, _g = loss_inputs(t, v, dtype, dev, 400 + si)
        lb[0], lb[1] = -1, v                     # out of range: loss = logZ
        if label == "unaligned":
            buf = torch.empty(t * v + 1, dtype=dtype, device=dev)
            buf[1:].copy_(x.reshape(-1))
            x = buf[1:].view(t, v)
        o_k = fused_cross_entropy(x, lb)
        o_p = fused_cross_entropy_plain(x, lb)
        sync(dev)
        err = max_err(o_k, o_p)
        require(bool(torch.isfinite(o_k).all()), f"CE {label}: non-finite")
        # both sum the same fp32 terms in other orders: within 1e-5
        require(err <= 1e-5, f"CE {label}: max|kernel-plain| {err:.3e} > 1e-5")
        log(f"CE kernel {label} (T={t}, V={v}, {str(dtype)[6:]}): "
            f"max|kernel-plain| {err:.3e} (tol 1e-05)")
        if label != "main":
            continue
        lb64 = lb.clamp(0, v - 1).long()
        es = x.element_size()
        tb = (t * v * es + 2 * t * 4) / HBM_BPS * 1e3
        tf = LOSS_OPS["ce"][0] * t * v / PEAK_FLOPS[torch.float32] * 1e3
        results["fused_cross_entropy"] = {
            "ms": time_ms(lambda: fused_cross_entropy(x, lb), flush, iters=20),
            "plain_ms": time_ms(lambda: fused_cross_entropy_plain(x, lb),
                                flush, iters=5, warmup=1),
            "library_ms": time_ms(lambda: F.cross_entropy(
                x, lb64, reduction="none"), flush, iters=20),
            "bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations",
            "max_abs_err": err}
        r = results["fused_cross_entropy"]
        log(f"  fused_cross_entropy bf16: kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms "
            f"(F.cross_entropy)  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        del x, _tg
    sdpa = F.scaled_dot_product_attention
    for si, (label, b, s, t, h, kvh, hd, causal, window, dtype) in \
            enumerate(FLASH_SHAPES):
        q, k, v = flash_inputs(b, s, t, h, kvh, hd, dtype, dev, 500 + si,
                               label.endswith("unaligned"))
        o_k = flash_attention(q, k, v, causal, window)
        o_p = flash_attention_plain(q, k, v, causal, window)
        sync(dev)
        err = check_flash(label, o_k, o_p, dtype)
        log(f"flash kernel {label} (B={b}, S={s}, T={t}, H={h}, KVh={kvh}, "
            f"hd={hd}, causal={causal}, window={window}, {str(dtype)[6:]}): "
            f"max|kernel-plain| {err:.3e}")
        if label not in TIMED_FLASH:
            continue
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = attention_mask(s, t, causal, window, dev) if window else None
        b_ms, b_by = flash_bound(b, s, t, h, kvh, hd, causal, window, dtype,
                                 dev)
        r = {"ms": time_ms(lambda: flash_attention(q, k, v, causal, window),
                           flush, iters=10),
             "plain_ms": time_ms(lambda: flash_attention_plain(
                 q, k, v, causal, window), flush, iters=3, warmup=1),
             "library_ms": time_ms(lambda: sdpa(
                 qt, kt, vt, attn_mask=mask, is_causal=mask is None and causal,
                 enable_gqa=True), flush, iters=10),
             "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
        if label == "b":
            results["flash_attention"] = r
        log(f"  flash_attention {label} bf16: kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms "
            f"(SDPA, enable_gqa)  bound {b_ms:.4f} ms ({b_by}); kernel / "
            f"library {r['ms'] / r['library_ms']:.1f}x")
        del q, k, v, o_k, o_p
    torch.cuda.empty_cache()
    return results


def loss_inputs(t: int, v: int, dtype, dev: torch.device, seed: int,
                unaligned: bool = False):
    """Student logits (N(0, 2^2)), a correlated target, labels spread over
    all of V and three rows of per-token cotangents. ``unaligned`` puts the
    target at a 2-byte offset from any 16-byte boundary."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((t, v), generator=gen, device=dev) * 2.0
    tg = (x + 0.5 * torch.randn((t, v), generator=gen, device=dev)).to(dtype)
    labels = torch.randint(0, v, (t,), generator=gen, device=dev,
                           dtype=torch.int32)
    g = torch.randn((3, t), generator=gen, device=dev)
    if unaligned:
        buf = torch.empty(t * v + 1, dtype=dtype, device=dev)
        buf[1:].copy_(tg.reshape(-1))
        tg = buf[1:].view(t, v)
    return x.to(dtype), tg, labels, g


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_loss_output(name: str, label: str, k: torch.Tensor, p: torch.Tensor,
                      grad: bool, fp32: bool, errs: dict) -> float:
    """A loss kernel's output ``k`` against its plain version ``p``.
    Per-token outputs: both accumulate in fp32 in other orders (~1e-7
    relative), within 1e-5; from bf16 inputs within 1e-3 of the output's
    scale. Gradients: fp32 within 1e-5; bf16 element by element, within one
    bf16 ulp of each element (``bf16_grad_misses``). Keeps the largest
    error at the main shape in ``errs[name]``. ``fp32``: the inputs'
    dtype."""
    err = max_err(k, p)
    require(bool(torch.isfinite(k).all()),
            f"{name} {label}: non-finite kernel output")
    if grad and not fp32:
        bad = bf16_grad_misses(k, p)
        require(bad == 0, f"{name} {label}: {bad} gradient elements beyond "
                f"one bf16 ulp of the plain version (max |kernel-plain| "
                f"{err:.3e})")
    else:
        tol = 1e-5 if fp32 else 1e-3 * max(float(p.abs().max()), 1e-30)
        require(err <= tol, f"{name} {label}: max|kernel-plain| {err:.3e} > "
                f"tol {tol:.3e}")
    if label == "main":
        errs[name] = max(errs.get(name, 0.0), err)
    return err


# fp32 operations per logits element, for the operations bound: CE forward
# (max, sub, exp, add, add), CE backward (sub, exp, mul, sub, sub, add),
# and per distillation mode what it adds to each (mse: sub, mul, add;
# kl: max, sub, exp, add, sub, mul-add / exp, sub, mul, sub, mul)
LOSS_OPS = {"ce": (5, 6), "mse": (8, 10), "kl": (11, 12)}


def phase_loss_kernels(dev: torch.device, flush: torch.Tensor):
    """The four loss kernels against their plain versions at LOSS_SHAPES,
    forward outputs and residuals and backward gradients (dt written and
    dt skipped); times at the main-path shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import (fused_ce_distill_grad,
                                     fused_ce_distill_grad_plain,
                                     fused_ce_distill_parts,
                                     fused_ce_distill_parts_plain,
                                     fused_cross_entropy_grad,
                                     fused_cross_entropy_grad_plain,
                                     fused_cross_entropy_parts,
                                     fused_cross_entropy_parts_plain)
    errs = {}
    results = {}
    for si, (label, t, v, dtype, v_real) in enumerate(LOSS_SHAPES):
        x, tg, lb, g = loss_inputs(t, v, dtype, dev, 100 + si,
                                   unaligned=label == "unaligned")

        def check(name, k, p, grad):
            return check_loss_output(name, label, k, p, grad,
                                     dtype == torch.float32, errs)

        out_k = fused_cross_entropy_parts(x, lb, v_real)
        out_p = fused_cross_entropy_parts_plain(x, lb, v_real)
        e6 = max(check("fused_cross_entropy_parts", a, b, False)
                 for a, b in zip(out_k, out_p))
        logz = out_p[2]
        dx_k = fused_cross_entropy_grad(x, lb, logz, g[0], g[1], v_real)
        dx_p = fused_cross_entropy_grad_plain(x, lb, logz, g[0], g[1], v_real)
        e7 = check("fused_cross_entropy_grad", dx_k, dx_p, True)
        msg = [f"ce fwd {e6:.2e} bwd {e7:.2e}"]
        for mode in ("mse", "kl"):
            (o_k, r_k) = fused_ce_distill_parts(x, tg, lb, mode, v_real)
            (o_p, r_p) = fused_ce_distill_parts_plain(x, tg, lb, mode, v_real)
            e12 = max(check("fused_ce_distill_parts", a, b, False)
                      for a, b in zip(o_k + r_k, o_p + r_p))
            e13 = 0.0
            for need_dt in (True, False):
                ds_k, dt_k = fused_ce_distill_grad(
                    x, tg, lb, r_p, g[0], g[1], g[2], mode, v_real, need_dt)
                ds_p, dt_p = fused_ce_distill_grad_plain(
                    x, tg, lb, r_p, g[0], g[1], g[2], mode, v_real, need_dt)
                e13 = max(e13, check("fused_ce_distill_grad", ds_k, ds_p, True))
                if need_dt:
                    e13 = max(e13, check("fused_ce_distill_grad", dt_k, dt_p,
                                         True))
                else:
                    require(dt_k is None, "dt returned though not asked for")
            msg.append(f"{mode} fwd {e12:.2e} bwd {e13:.2e}")
        sync(dev)
        log(f"loss kernels {label} (T={t}, V={v}, v_real={v_real or v}, "
            f"{str(dtype).replace('torch.', '')}): max|kernel-plain| "
            + "; ".join(msg))
        if label != "main":
            continue

        # ---- times at the main-path shape ----
        es = x.element_size()
        tv = t * v
        lb64 = lb.long()
        xr = x.detach().clone().requires_grad_(True)
        lib_y = F.cross_entropy(xr, lb64, reduction="none")
        (o_mse, r_mse) = fused_ce_distill_parts_plain(x, tg, lb, "mse")

        def bound(n_bytes, n_ops):
            tb = n_bytes / HBM_BPS * 1e3
            tf = n_ops / PEAK_FLOPS[torch.float32] * 1e3
            return max(tb, tf), ("bytes" if tb >= tf else "operations")

        # bytes: each (T, V) operand read once, each output written once,
        # plus the (T,) labels, residuals, cotangents and outputs (4 B each)
        specs = {
            "fused_cross_entropy_parts": (
                lambda: fused_cross_entropy_parts(x, lb),
                lambda: fused_cross_entropy_parts_plain(x, lb),
                lambda: F.cross_entropy(x, lb64, reduction="none"),
                bound(tv * es + 4 * t * 4, LOSS_OPS["ce"][0] * tv)),
            "fused_cross_entropy_grad": (
                lambda: fused_cross_entropy_grad(x, lb, logz, g[0], g[1]),
                lambda: fused_cross_entropy_grad_plain(x, lb, logz, g[0], g[1]),
                lambda: torch.autograd.grad(lib_y, xr, g[0], retain_graph=True),
                bound(2 * tv * es + 4 * t * 4, LOSS_OPS["ce"][1] * tv)),
            "fused_ce_distill_parts": (
                lambda: fused_ce_distill_parts(x, tg, lb, "mse"),
                lambda: fused_ce_distill_parts_plain(x, tg, lb, "mse"),
                None,
                bound(2 * tv * es + 5 * t * 4, LOSS_OPS["mse"][0] * tv)),
            "fused_ce_distill_grad": (
                lambda: fused_ce_distill_grad(x, tg, lb, r_mse, g[0], g[1],
                                              g[2], "mse",
                                              need_target_grad=False),
                lambda: fused_ce_distill_grad_plain(x, tg, lb, r_mse, g[0],
                                                    g[1], g[2], "mse",
                                                    need_target_grad=False),
                None,
                bound(3 * tv * es + 5 * t * 4, LOSS_OPS["mse"][1] * tv)),
        }
        for kname, (kern, plain, lib, (b_ms, b_by)) in specs.items():
            results[kname] = {
                "ms": time_ms(kern, flush, iters=20),
                "plain_ms": time_ms(plain, flush, iters=5, warmup=1),
                "library_ms": None if lib is None else time_ms(lib, flush,
                                                               iters=20),
                "bound_ms": b_ms, "bound_by": b_by,
                "max_abs_err": errs[kname]}
            r = results[kname]
            lib_txt = ("—" if r["library_ms"] is None
                       else f"{r['library_ms']:.4f} ms")
            log(f"  {kname} bf16 (mse): kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {lib_txt}  bound "
                f"{b_ms:.4f} ms ({b_by})")
        (_o, r_kl) = fused_ce_distill_parts_plain(x, tg, lb, "kl")
        extra = {
            "fused_ce_distill_parts kl": (
                lambda: fused_ce_distill_parts(x, tg, lb, "kl"),
                bound(2 * tv * es + 7 * t * 4, LOSS_OPS["kl"][0] * tv)),
            "fused_ce_distill_grad kl": (
                lambda: fused_ce_distill_grad(x, tg, lb, r_kl, g[0], g[1],
                                              g[2], "kl",
                                              need_target_grad=False),
                bound(3 * tv * es + 7 * t * 4, LOSS_OPS["kl"][1] * tv)),
            "fused_ce_distill_grad mse with dt": (
                lambda: fused_ce_distill_grad(x, tg, lb, r_mse, g[0], g[1],
                                              g[2], "mse"),
                bound(4 * tv * es + 5 * t * 4, LOSS_OPS["mse"][1] * tv)),
        }
        for kname, (kern, (b_ms, b_by)) in extra.items():
            log(f"  {kname} bf16: kernel {time_ms(kern, flush, iters=20):.4f}"
                f" ms  bound {b_ms:.4f} ms ({b_by})")
        del xr, lib_y
    torch.cuda.empty_cache()
    return results


# fp32 operations per logits element of the distillation kernels: mse
# forward (sub, mul, add) and backward (sub, mul, mul); kl forward (the
# student's max, sub, exp, add and the target's max, sub, exp, add, sub,
# mul, add) and backward (sub, exp, sub, exp, sub, mul, sub, sub, mul, mul)
DISTILL_OPS = {"mse": (3, 3), "kl": (11, 10)}


def phase_distill_kernels(dev: torch.device, flush: torch.Tensor):
    """Rows 8-11, the distillation kernels alone, against their plain
    versions at DISTILL_SHAPES: row 8 mse (with v_total < V at the
    "v_real<V" shape) and kl, row 9's loss and residuals, rows 10 and 11
    with the target gradient written and skipped; times at the main-path
    shape (returned) and the subsample shape (printed), and row 8 mse's at
    the canary's (returned as ``canary_*``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import (fused_distill_kl_grad,
                                     fused_distill_kl_grad_plain,
                                     fused_distill_kl_parts,
                                     fused_distill_kl_parts_plain,
                                     fused_distill_loss,
                                     fused_distill_loss_plain,
                                     fused_distill_mse_grad,
                                     fused_distill_mse_grad_plain)
    errs = {}
    results = {}
    for si, (label, t, v, dtype, v_total) in enumerate(DISTILL_SHAPES):
        x, tg, _lb, g = loss_inputs(t, v, dtype, dev, 200 + si,
                                    unaligned=label == "unaligned")
        gd = g[2].contiguous()

        def check(name, k, p, grad):
            return check_loss_output(name, label, k, p, grad,
                                     dtype == torch.float32, errs)

        e8 = max(check("fused_distill_loss",
                       fused_distill_loss(x, tg, mode, v_total),
                       fused_distill_loss_plain(x, tg, mode, v_total), False)
                 for mode in ("mse", "kl"))
        parts = fused_distill_kl_parts_plain(x, tg)
        e9 = max(check("fused_distill_kl_parts", a, b, False)
                 for a, b in zip(fused_distill_kl_parts(x, tg), parts))
        res = parts[1:]
        e10 = e11 = 0.0
        for need in (True, False):
            for name, kern, plain in (
                    ("fused_distill_mse_grad", fused_distill_mse_grad,
                     fused_distill_mse_grad_plain),
                    ("fused_distill_kl_grad", fused_distill_kl_grad,
                     fused_distill_kl_grad_plain)):
                args = ((gd, v_total) if name == "fused_distill_mse_grad"
                        else (*res, gd))
                da, db = kern(x, tg, *args, need_target_grad=need)
                pa, pb = plain(x, tg, *args, need_target_grad=need)
                err = check(name, da, pa, True)
                if need:
                    err = max(err, check(name, db, pb, True))
                else:
                    require(db is None, f"{name}: dB returned though not "
                            "asked for")
                if name == "fused_distill_mse_grad":
                    e10 = max(e10, err)
                else:
                    e11 = max(e11, err)
        sync(dev)
        log(f"distill kernels {label} (T={t}, V={v}, v_total={v_total or v}, "
            f"{str(dtype).replace('torch.', '')}): max|kernel-plain| row 8 "
            f"{e8:.2e}, row 9 {e9:.2e}, row 10 {e10:.2e}, row 11 {e11:.2e}")
        if label not in ("main", "subsample", "canary"):
            continue

        # ---- times at the main-path, subsample and canary shapes ----
        es = x.element_size()
        tv = t * v

        def bound(n_bytes, n_ops):
            tb = n_bytes / HBM_BPS * 1e3
            tf = n_ops / PEAK_FLOPS[torch.float32] * 1e3
            return max(tb, tf), ("bytes" if tb >= tf else "operations")

        # bytes: each (T, V) operand read once, each output written once,
        # plus the (T,) outputs, residuals and cotangents (4 B each)
        mse_ops, kl_ops = DISTILL_OPS["mse"], DISTILL_OPS["kl"]
        if label == "canary":
            b_ms, b_by = bound(2 * tv * es + t * 4, mse_ops[0] * tv)
            r = {"ms": time_ms(lambda: fused_distill_loss(x, tg, "mse"),
                               flush),
                 "plain_ms": time_ms(lambda: fused_distill_loss_plain(
                     x, tg, "mse"), flush),
                 "library_ms": time_ms(lambda: F.mse_loss(x, tg), flush),
                 "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": e8}
            results["fused_distill_loss"].update(
                {f"canary_{k}": r[k] for k in ("ms", "plain_ms", "library_ms",
                                               "bound_ms", "max_abs_err")})
            log(f"  fused_distill_loss mse canary (T=1) fp32: kernel "
                f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library "
                f"{r['library_ms']:.4f} ms  bound {b_ms:.5f} ms ({b_by})")
            continue
        xr = x.detach().clone().requires_grad_(True)
        lib_mse = F.mse_loss(xr, tg)
        specs = {
            "fused_distill_loss": (
                lambda: fused_distill_loss(x, tg, "mse"),
                lambda: fused_distill_loss_plain(x, tg, "mse"),
                lambda: F.mse_loss(x, tg),
                bound(2 * tv * es + t * 4, mse_ops[0] * tv)),
            "fused_distill_kl_parts": (
                lambda: fused_distill_kl_parts(x, tg),
                lambda: fused_distill_kl_parts_plain(x, tg),
                None, bound(2 * tv * es + 4 * t * 4, kl_ops[0] * tv)),
            "fused_distill_mse_grad": (
                lambda: fused_distill_mse_grad(x, tg, gd,
                                               need_target_grad=False),
                lambda: fused_distill_mse_grad_plain(x, tg, gd,
                                                     need_target_grad=False),
                lambda: torch.autograd.grad(lib_mse, xr, retain_graph=True),
                bound(3 * tv * es + t * 4, mse_ops[1] * tv)),
            "fused_distill_kl_grad": (
                lambda: fused_distill_kl_grad(x, tg, *res, gd,
                                              need_target_grad=False),
                lambda: fused_distill_kl_grad_plain(x, tg, *res, gd,
                                                    need_target_grad=False),
                None, bound(3 * tv * es + 4 * t * 4, kl_ops[1] * tv)),
        }
        for kname, (kern, plain, lib, (b_ms, b_by)) in specs.items():
            r = {"ms": time_ms(kern, flush, iters=20),
                 "plain_ms": time_ms(plain, flush, iters=5, warmup=1),
                 "library_ms": None if lib is None else time_ms(lib, flush,
                                                                iters=20),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "max_abs_err": errs[kname]}
            if label == "main":
                results[kname] = r
            lib_txt = ("—" if r["library_ms"] is None
                       else f"{r['library_ms']:.4f} ms")
            log(f"  {kname} {label} (T={t}) bf16: kernel {r['ms']:.4f} ms  "
                f"plain {r['plain_ms']:.4f} ms  library {lib_txt}  bound "
                f"{b_ms:.4f} ms ({b_by})")
        extra = {
            "fused_distill_loss kl": (
                lambda: fused_distill_loss(x, tg, "kl"),
                bound(2 * tv * es + t * 4, kl_ops[0] * tv)),
            "fused_distill_mse_grad with dB": (
                lambda: fused_distill_mse_grad(x, tg, gd),
                bound(4 * tv * es + t * 4, mse_ops[1] * tv)),
            "fused_distill_kl_grad with dB": (
                lambda: fused_distill_kl_grad(x, tg, *res, gd),
                bound(4 * tv * es + 4 * t * 4, kl_ops[1] * tv)),
        }
        for kname, (kern, (b_ms, b_by)) in extra.items():
            log(f"  {kname} {label} (T={t}) bf16: kernel "
                f"{time_ms(kern, flush, iters=20):.4f} ms  bound {b_ms:.4f} "
                f"ms ({b_by})")
        del xr, lib_mse
    torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------------
# phase 4: full-width fleet
# ----------------------------------------------------------------------------

def serving_kernels(quantized: bool):
    return (("paged_attention_decode_quant", "paged_scatter_quant")
            if quantized else ("paged_attention_decode", "paged_scatter"))


def serve_launches(router, n_layers: int, k: int, fused: bool,
                   quantized: bool) -> dict:
    """Launches of rows 1-4 in one fleet run: a plain tick (a plain
    engine's, or a speculative engine's fallback) launches the decode and
    one K+V scatter per layer; a speculative round launches k draft ticks
    and one verify: k + 1 decodes (the verify's over S*k pseudo-slots) and
    2k scatters per layer. The gather path gathers K and V (and their two
    scale pools) instead of each decode."""
    from repro_torch.serve.fleet import SpecEngine
    plain = sum(e.decode_ticks for e in router.engines)
    rounds = sum(e.spec_stats.rounds for e in router.engines
                 if isinstance(e, SpecEngine))
    dec, sc = serving_kernels(quantized)
    attn_calls = n_layers * (plain + (k + 1) * rounds)
    want = dict.fromkeys(ROWS_1_TO_4, 0)
    want[sc] = n_layers * (plain + 2 * k * rounds)
    if fused:
        want[dec] = attn_calls
    else:
        want["paged_gather"] = (4 if quantized else 2) * attn_calls
    return want


def serve_run(model, peers, fc, wl, cache_dtype, dev, label, spec=None):
    """One seeded fleet run through ``FleetRouter.run`` (round robin, or
    speculative with ``SpecConfig(k=spec)``), launch counts set to 0 just
    before and read just after, the wall time of each decode tick or
    speculative round on the side. Checks completion, nothing lost or
    duplicated, token ids in range and count, and rows 1-4's launches
    against the ticks and rounds. Returns (router, report, counts of rows
    1-4, per-tick or per-round wall ms, wall s)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.fleet import (FleetEngine, FleetRouter,
                                         SpecConfig, SpecEngine)
    policy = "speculative" if spec else "round_robin"
    cls, name = (SpecEngine, "_spec_round") if spec else (FleetEngine,
                                                          "_decode_tick")
    orig, walls = getattr(cls, name), []

    def timed(self, *a):
        t0 = time.perf_counter()
        out = orig(self, *a)
        if out:                       # a tick with no live slot is not timed
            walls.append((time.perf_counter() - t0) * 1e3)
        return out

    router = FleetRouter(model, peers, config=fc, policy=policy,
                         cache_dtype=cache_dtype, device=dev,
                         spec=SpecConfig(k=spec) if spec else None)
    setattr(cls, name, timed)
    try:
        sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = router.run(wl, slo_ms=50.0)
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        setattr(cls, name, orig)
    counts = {k: launch_counts[k] for k in ROWS_1_TO_4}
    quantized = cache_dtype in QUANT
    log(f"  {label} {policy}: completed {rep.completed}/{len(wl.requests)}, "
        f"{rep.generated_tokens} tokens, {len(walls)} "
        f"{'rounds' if spec else 'decode ticks'} at {np.mean(walls):.2f} ms "
        f"wall each, {wall:.2f} s wall ({rep.generated_tokens / wall:.1f} "
        f"tokens/s wall, prefill included), KV bytes a token "
        f"{router.engines[0]._kv_bytes_per_token}; "
        + (f"accept rate {rep.spec_accept_rate:.4f} ({rep.spec_accepted_tokens}"
           f"/{rep.spec_drafted_tokens}), fallback ticks "
           f"{rep.spec_fallback_ticks}; " if spec else "")
        + f"launches { {k: n for k, n in counts.items() if n} }")
    require(rep.completed == len(wl.requests) and rep.rejected == 0,
            f"{label} {policy}: {rep.completed} completed, {rep.rejected} "
            "rejected")
    require(rep.lost_tokens == 0 and rep.duplicated_tokens == 0,
            f"{label} {policy}: lost {rep.lost_tokens}, duplicated "
            f"{rep.duplicated_tokens}")
    toks = [t for r in router._primaries for t in r.tokens]
    require(all(0 <= t < model.cfg.padded_vocab for t in toks)
            and len(toks) == rep.generated_tokens,
            f"{label} {policy}: token ids out of range or miscounted")
    want = serve_launches(router, model.cfg.num_layers, spec or 0,
                          fc.fused_attention is not False, quantized)
    require(counts == want, f"{label} {policy}: launches {counts} != "
            f"{want} (from the ticks and rounds)")
    return router, rep, counts, walls, wall


def tick_check(model, peer, fc, wl, cache_dtype, dev: torch.device):
    """One engine with 16 live slots: a fused tick against a gather tick on
    the same pool, launch counts of the gather tick, then the wall time of
    5 fused ticks. Returns (engine, active, tokens, gather counts, ms per
    tick)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.fleet import FleetEngine, Request
    from repro_torch.serve.fleet.model_exec import build_decode_step
    name = str(cache_dtype)[6:]
    eng = FleetEngine(model, peer, replace(fc, max_prefills_per_step=S),
                      cache_dtype=cache_dtype, device=dev)
    for r in wl.requests[:S]:
        eng.enqueue(Request(r.rid, 0.0, r.prompt, 32))
    eng._intake()
    eng._admit()
    require(len(eng.slots) == S, f"only {len(eng.slots)} slots admitted")
    active = np.ones((S,), bool)
    tokens = np.zeros((S, 1), np.int32)
    for s, sl in eng.slots.items():
        tokens[s, 0] = sl.next_token
    fused = eng.decode_logits(active, tokens).float()
    fused_step, eng._decode = eng._decode, build_decode_step(
        model, fused_attention=False)
    reset_launch_counts()
    oracle = eng.decode_logits(active, tokens).float()
    sync(dev)
    oracle_counts = dict(launch_counts)
    eng._decode = fused_step
    scale = float(fused.abs().max())
    diff = float((fused - oracle).abs().max())
    agree = int((fused.argmax(-1) == oracle.argmax(-1)).sum())
    # bf16 activations round differently on the two attention paths (fp32
    # kernel state vs bf16 scores/weights of the oracle), and the difference
    # compounds over 28 layers: allow 5% of the logits' max magnitude
    log(f"fused vs gather tick {name}: max|dlogits| = {diff:.4f} "
        f"(max|logits| {scale:.3f}, tol {0.05 * scale:.4f}), argmax agree "
        f"{agree}/{S}, gather launches "
        f"{ {k: n for k, n in oracle_counts.items() if n} }")
    require(bool(torch.isfinite(fused).all() and torch.isfinite(oracle).all()),
            f"non-finite decode logits ({name})")
    require(diff <= 0.05 * scale,
            f"fused vs gather logits differ by {diff} ({name})")
    sync(dev)
    t0 = time.perf_counter()
    n_ticks = 5
    for _ in range(n_ticks):
        eng.decode_logits(active, tokens)
    sync(dev)
    tick_ms = (time.perf_counter() - t0) / n_ticks * 1e3
    ctx = [int(x) for x in eng.pool.lengths]
    log(f"decode tick {name} (16 live slots, contexts {min(ctx)}.."
        f"{max(ctx)}): {tick_ms:.2f} ms wall/tick = {S / tick_ms * 1e3:.1f} "
        "tokens/s")
    return eng, active, tokens, oracle_counts, tick_ms


def phase_fleet(dev: torch.device, cfg):
    """qwen2-7b at full width, 2 peers, the seeded bursty workload over
    bf16 pools, then over int8 and fp8 pools; launch counts checked
    against the decode ticks of each run; a fused-vs-gather tick over each
    pool type, with its device profile."""
    from repro_torch.models import build_model
    from repro_torch.serve.fleet import FleetConfig, generate_workload
    model = build_model(cfg)
    t0 = time.perf_counter()
    peers = []
    for i in range(2):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1234 + i)
        peers.append(model.init(gen, device=dev, weight_dtype=torch.bfloat16))
    sync(dev)
    log(f"fleet: qwen2-7b {cfg.num_layers} layers d_model {cfg.d_model}, "
        f"2 peers initialised in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    fc = FleetConfig(max_slots=16, block_size=16, num_blocks=1025,
                     max_blocks_per_slot=34, fused_attention=True)
    wl = generate_workload("bursty", 24, cfg.padded_vocab, seed=0,
                           max_prompt=512, max_new=32)
    n_layers = cfg.num_layers
    # one launch writes a layer's K and V pools: one per attention
    # sub-layer per tick (serve_run holds the counts to the ticks)
    router, _rep, counts, _t, _w = serve_run(model, peers, fc, wl,
                                             torch.bfloat16, dev, "fleet bf16")
    bf16_tokens = {r.request.rid: r.tokens for r in router._primaries}
    out = {k: counts[k] for k in ("paged_scatter", "paged_attention_decode")}
    eng, active, tokens, g_counts, tick_ms = tick_check(
        model, peers[0], fc, wl, torch.bfloat16, dev)
    require(g_counts["paged_gather"] == 2 * n_layers
            and g_counts["paged_scatter"] == n_layers
            and g_counts["paged_attention_decode"] == 0,
            f"gather tick launches {g_counts}")
    out["paged_gather"] = g_counts["paged_gather"]
    if dev.type == "cuda":
        profile_ticks(eng, active, tokens, tick_ms)
    del eng, router
    torch.cuda.empty_cache()

    # the same peers and workload over quantized pools
    for qdt in QUANT:
        name = str(qdt)[6:]
        router, _rep, counts, _t, _w = serve_run(model, peers, fc, wl, qdt,
                                                 dev, f"fleet {name}")
        per_token = router.engines[0]._kv_bytes_per_token
        require(per_token == n_layers * 2 * (
                    cfg.num_kv_heads * cfg.resolved_head_dim + 4),
                f"{name}: {per_token} KV bytes per token")
        for k in ("paged_scatter_quant", "paged_attention_decode_quant"):
            out[k] = out.get(k, 0) + counts[k]
        same = sum(int(a == b) for r in router._primaries
                   for a, b in zip(r.tokens, bf16_tokens[r.request.rid]))
        n_tok = sum(len(r.tokens) for r in router._primaries)
        log(f"fleet {name}: {same}/{n_tok} tokens equal to the bf16 run's "
            f"({same / n_tok:.1%}; for information)")
        del router
        eng, active, tokens, g_counts, tick_ms = tick_check(
            model, peers[0], fc, wl, qdt, dev)
        require(g_counts["paged_gather"] == 4 * n_layers
                and g_counts["paged_scatter_quant"] == n_layers
                and g_counts["paged_attention_decode_quant"] == 0,
                f"{name} gather tick launches {g_counts}")
        out["paged_gather"] += g_counts["paged_gather"]
        if dev.type == "cuda":
            profile_ticks(eng, active, tokens, tick_ms)
        del eng
        torch.cuda.empty_cache()
    return out


def profile_ticks(eng, active, tokens, tick_ms: float, n: int = 3) -> None:
    """Device time of ``n`` decode ticks by kernel (torch.profiler) against
    their wall time: the device's busy share of a tick, and the decode
    attention's own device time in it."""
    profile_device(lambda: eng.decode_logits(active, tokens), tick_ms, n,
                   "tick", detail=("decode_", "scatter"))


def kernel_times(fn, n: int):
    """[(device us, calls, name)] of the kernels of ``n`` calls of ``fn``
    (torch.profiler), the longest first."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue         # CPU ops also report their kernels' time
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, e.count, e.key))
    return sorted(rows, reverse=True)


def profile_device(fn, wall_ms: float, n: int, unit: str, detail=()):
    """Device time of ``n`` calls of ``fn`` by kernel (torch.profiler)
    against their wall time ``wall_ms`` per call: the device's busy share;
    for each string of ``detail``, also the summed time of the kernels
    whose name holds it. Returns the busy ms per call (None if the profiler saw no device
    time)."""
    rows = kernel_times(fn, n)
    busy_ms = sum(r[0] for r in rows) / 1e3 / n
    if not rows:
        log("profile: the profiler reported no device time (not measured)")
        return None
    log(f"profile: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall per "
        f"{unit} ({busy_ms / wall_ms:.1%}); top kernels by device time per "
        f"{unit}:")
    for us, count, key in rows[:8]:
        log(f"  {us / 1e3 / n:8.3f} ms  {count // n:5d} calls  {key[:90]}")
    for d in detail:
        parts = [(us, count, key) for us, count, key in rows if d in key]
        log(f"  kernels named *{d}*: {sum(r[0] for r in parts) / 1e3 / n:.4f}"
            f" ms and {sum(r[1] for r in parts) // n} calls per {unit}")
    return busy_ms


# ----------------------------------------------------------------------------
# phase 5: card vs CPU (fp32 weights; fp32, int8 and fp8 pools)
# ----------------------------------------------------------------------------

def quant_steps(a: torch.Tensor, b: torch.Tensor):
    """(elements that differ, all of them one quantization step apart?) for
    two int8 or e4m3 payloads of one shape: int8 codes 1 apart, or e4m3
    codes of one sign 1 apart (the encoding is monotone in magnitude)."""
    if a.dtype == torch.int8:
        d = (a.int() - b.int()).abs()
        return int((d != 0).sum()), bool((d <= 1).all())
    ua, ub = a.view(torch.uint8).int(), b.view(torch.uint8).int()
    diff = ua != ub
    one = ((ua ^ ub) < 0x80) & ((ua - ub).abs() == 1)
    return int(diff.sum()), bool((one | ~diff).all())


def compare_quant_pools(engines, name: str, when: str) -> None:
    """The card's and the CPU's quantized pools: every payload element that
    differs is one quantization step off, and at most 0.1% differ."""
    n_diff = n_all = 0
    for sub, pools in engines["card"].pool.kv.items():
        for pname in ("k", "v"):
            a = pools[pname].cpu()
            b = engines["cpu"].pool.kv[sub][pname]
            nd, one_step = quant_steps(a, b)
            require(one_step, f"{name} {sub} {pname} {when}: a payload "
                    "element differs by more than one step")
            n_diff += nd
            n_all += a.numel()
    log(f"parity {name}: pools {when}: {n_diff} of {n_all} payload elements "
        f"differ card vs CPU, each by one step ({n_diff / n_all:.5%}; limit "
        f"0.1%)")
    require(n_diff <= 1e-3 * n_all,
            f"{name} {when}: {n_diff} of {n_all} payload elements differ")


PARITY_FIELDS = ("completed", "rejected", "kv_bytes_written", "lost_tokens",
                 "duplicated_tokens")


def phase_parity(dev: torch.device):
    """Reduced qwen2-7b in fp32, the card against the CPU on the same
    weights and workload, over fp32, int8 and fp8 pools."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.serve.fleet import (FleetConfig, FleetEngine, FleetRouter,
                                         Request, generate_workload)
    cfg = get_reduced("qwen2-7b")
    model = build_model(cfg)
    params = {}
    for i in range(2):
        gen = torch.Generator()
        gen.manual_seed(77 + i)
        params.setdefault("cpu", []).append(model.init(gen, device="cpu"))
    to_dev = lambda tree: ({k: to_dev(v) for k, v in tree.items()}  # noqa: E731
                           if isinstance(tree, dict) else tree.to(dev))
    params["card"] = [to_dev(p) for p in params["cpu"]]
    devices = {"cpu": torch.device("cpu"), "card": dev}
    wl = generate_workload("bursty", 8, cfg.padded_vocab, seed=3,
                           max_prompt=40, max_new=12)
    fc = FleetConfig(max_slots=3, block_size=4, num_blocks=64,
                     max_blocks_per_slot=16, max_prefills_per_step=1)
    for cache_dtype in (torch.float32, *QUANT):
        name = str(cache_dtype)[6:]
        quantized = cache_dtype in QUANT
        reps = {d: FleetRouter(model, params[d], config=fc,
                               policy="least_loaded", cache_dtype=cache_dtype,
                               device=devices[d]).run(wl).to_dict()
                for d in devices}
        bad = {k: (reps["cpu"][k], reps["card"][k]) for k in reps["cpu"]
               if reps["cpu"][k] != reps["card"][k]}
        log(f"parity {name}: FleetReport card vs CPU: "
            f"{len(reps['cpu']) - len(bad)}/{len(reps['cpu'])} fields equal, "
            f"digests {'equal' if 'stream_digest' not in bad else 'differ'} "
            f"({reps['card']['stream_digest'][:16]})")
        if quantized:
            # a 1e-7 difference in K before quantization can flip one
            # element by a step, and with it a token: the counts must agree
            require(not any(f in bad for f in PARITY_FIELDS),
                    f"{name}: FleetReport counts differ card vs CPU: {bad}")
        else:
            require(not bad, f"FleetReport fields differ card vs CPU: {bad}")

        # teacher-forced: the same 8 prompts admitted on both devices, 4
        # ticks fed the CPU's argmax tokens on both
        logits, engines = {}, {}
        fc8 = replace(fc, max_slots=8, max_prefills_per_step=8)
        for d in devices:
            eng = FleetEngine(model, params[d][0], fc8, keep_logits=True,
                              cache_dtype=cache_dtype, device=devices[d])
            for r in wl.requests:
                eng.enqueue(Request(r.rid, 0.0, r.prompt, 8))
            eng._intake()
            eng._admit()
            logits[d] = [torch.from_numpy(np.stack(
                [eng.slots[s].record.prefill_logits for s in range(8)]))]
            engines[d] = eng
        if quantized:
            compare_quant_pools(engines, name, "after the prefill inserts")
        active = np.ones((8,), bool)
        tokens = np.asarray([[engines["cpu"].slots[s].next_token]
                             for s in range(8)], np.int32)
        for _ in range(4):
            for d, eng in engines.items():
                logits[d].append(eng.decode_logits(active, tokens).float().cpu())
                eng.pool.lengths[:] += 1
            tokens = logits["cpu"][-1].argmax(-1, keepdim=True).numpy().astype(
                np.int32)
        if quantized:
            # the 4 ticks' rows went through paged_scatter_quant on the card
            # and its plain version on the CPU
            compare_quant_pools(engines, name, "after the 4 ticks' appends")
        err = max(float((a - b).abs().max()) for a, b in zip(logits["cpu"],
                                                              logits["card"]))
        scale = max(float(a.abs().max()) for a in logits["cpu"])
        tol = 1e-3 * scale if quantized else 1e-4
        log(f"parity {name}: teacher-forced fp32 logits (prefill + 4 ticks) "
            f"max|card-cpu| = {err:.3e} (max|logits| {scale:.3f}, tol "
            f"{tol:.3e})")
        require(err <= tol, f"{name}: card vs CPU logits differ by {err}")


# ----------------------------------------------------------------------------
# phase 12: peer-speculative decoding at qwen2-7b's full width
# ----------------------------------------------------------------------------

SPEC_K = 4
# a noised peer: each weight plus this share of its leaf's std (bf16 runs:
# partial accepts; the fp32 check: enough to reject drafts at 4 layers)
SPEC_NOISE = 0.02
SPEC_NOISE_FP32 = 0.3


def noised_copy(params, rel: float, seed: int, dev: torch.device):
    """Each leaf plus ``rel`` times its std in seeded normal noise (norm
    scales, whose std is 0, stay): a peer that agrees with ``params`` on
    some argmaxes, not all."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        x = tree.float()
        noise = torch.randn(x.shape, generator=gen, device=dev)
        return (x + rel * x.std() * noise).to(tree.dtype)
    return walk(params)


def compare_streams(plain, spec, label: str) -> float:
    """The share of the speculative run's tokens equal to the plain run's
    at the same place, and the first divergence (for information)."""
    a = {r.request.rid: r.tokens for r in plain._primaries}
    b = {r.request.rid: r.tokens for r in spec._primaries}
    same = n = 0
    first = None
    for rid in sorted(a):
        for i, (x, y) in enumerate(zip(a[rid], b[rid])):
            n += 1
            same += int(x == y)
            if x != y and first is None:
                first = (rid, i)
    log(f"  {label}: {same}/{n} tokens ({same / max(n, 1):.1%}) equal to the "
        f"plain run's; first divergence "
        f"{'none' if first is None else f'request {first[0]} token {first[1]}'}")
    return same / max(n, 1)


def verify_check(model, peer, fc, wl, cache_dtype, dev, label: str,
                 exact: bool) -> None:
    """16 live slots (the workload's first 16 prompts): k sequential plain
    decode ticks against one k-token verify from the same pool on the same
    tokens, position by position (max |dlogits|, argmax agreement; required
    equal when ``exact``), with one verify's launches checked; and the undo
    log: the pools are cloned, the k rows of every slot snapshotted, then
    written (by the plain ticks, then by the verify) and restored, and the
    pools must equal the clones bit for bit both times."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.fleet import FleetEngine, Request
    from repro_torch.serve.fleet.model_exec import build_verify_step
    k = SPEC_K
    eng = FleetEngine(model, peer, replace(fc, max_prefills_per_step=S),
                      cache_dtype=cache_dtype, device=dev)
    for r in wl.requests[:S]:
        eng.enqueue(Request(r.rid, 0.0, r.prompt, 32))
    eng._intake()
    eng._admit()
    require(len(eng.slots) == S, f"only {len(eng.slots)} slots admitted")
    pool = eng.pool
    active = np.ones((S,), bool)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, model.cfg.vocab_size, size=(S, k))
    for s, sl in eng.slots.items():
        toks[s, 0] = sl.next_token
    base = pool.lengths.copy()
    before = {sub: {n: t.clone() for n, t in d.items()}
              for sub, d in pool.kv.items()}
    snaps = {s: pool.snapshot_rows(s, int(base[s]), k) for s in range(S)}

    def restored(when: str) -> None:
        for s in range(S):
            pool.restore_rows(snaps[s], start=0)
        sync(dev)
        same = all(bits_equal(t, before[sub][n])
                   for sub, d in pool.kv.items() for n, t in d.items())
        require(same, f"{label}: the pools differ from their clones after "
                f"restore_rows ({when})")

    seq = []
    for j in range(k):
        seq.append(eng.decode_logits(active, toks[:, j:j + 1]).float())
        pool.lengths += 1
    pool.lengths[:] = base
    restored("after k plain ticks")
    verify = build_verify_step(model, k, fc.fused_attention)
    wslots, woffs = pool.write_maps_k(active, k)
    reset_launch_counts()
    vlg = verify(eng.params, pool.kv, *(torch.as_tensor(x, device=dev) for x in
                 (pool.table, base, wslots, woffs, toks))).float()
    sync(dev)
    L = model.cfg.num_layers
    quantized = cache_dtype in QUANT
    dec, sc = serving_kernels(quantized)
    got = {n: launch_counts[n] for n in (dec, sc, "paged_gather")}
    fused = fc.fused_attention is not False
    want = {dec: L if fused else 0, sc: k * L,
            "paged_gather": 0 if fused else (4 if quantized else 2) * L}
    require(got == want, f"{label}: one verify launched {got} != {want}")
    restored("after the verify's scatters")
    diffs = [float((vlg[:, j] - seq[j]).abs().max()) for j in range(k)]
    agree = [int((vlg[:, j].argmax(-1) == seq[j].argmax(-1)).sum())
             for j in range(k)]
    scale = max(float(x.abs().max()) for x in seq)
    log(f"  {label}: verify vs {k} plain ticks, max|dlogits| by position "
        f"{[f'{d:.3e}' for d in diffs]} (max|logits| {scale:.3f}), argmax "
        f"agree {agree} of {S}; restore_rows bit-identical twice")
    require(bool(torch.isfinite(vlg).all()), f"{label}: non-finite verify")
    if exact:
        require(all(a == S for a in agree),
                f"{label}: verify argmax differs from plain decode: {agree}")


def phase_spec(dev: torch.device):
    """Peer-speculative decoding at qwen2-7b's full width and depth, the
    fleet phase's FleetConfig and bursty workload, k = 4, ring pairing:
    identical peers (the same tensors twice) and a noised copy of peer 0,
    over bf16 pools (fused, and the gather path once) and int8 / fp8 pools,
    each run plain and speculative; then the exactness check in fp32 at a
    depth of 4 layers. Returns the speculative runs' launches of rows 1-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.fleet import FleetConfig, generate_workload
    cfg = get_config("qwen2-7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    p0 = model.init(gen, device=dev, weight_dtype=torch.bfloat16)
    pn = noised_copy(p0, SPEC_NOISE, 99, dev)
    sync(dev)
    log(f"spec: qwen2-7b {cfg.num_layers} layers, a peer and its noised copy "
        f"in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    fc = FleetConfig(max_slots=16, block_size=16, num_blocks=1025,
                     max_blocks_per_slot=34, fused_attention=True)
    wl = generate_workload("bursty", 24, cfg.padded_vocab, seed=0,
                           max_prompt=512, max_new=32)
    out = {}
    runs = [("bf16 identical", [p0, p0], torch.bfloat16, fc),
            ("bf16 noised", [p0, pn], torch.bfloat16, fc),
            ("int8 identical", [p0, p0], torch.int8, fc),
            ("fp8 identical", [p0, p0], torch.float8_e4m3fn, fc),
            ("bf16 identical gather", [p0, p0], torch.bfloat16,
             replace(fc, fused_attention=False))]
    for label, peers, dtype, f in runs:
        plain, _rp, _c, ticks, _w = serve_run(model, peers, f, wl, dtype, dev,
                                              label)
        spec, rep, counts, rounds, _w = serve_run(model, peers, f, wl, dtype,
                                                  dev, label, spec=SPEC_K)
        compare_streams(plain, spec, label)
        log(f"  {label}: {np.mean(rounds):.2f} ms wall a speculative round "
            f"against {SPEC_K} plain ticks' {SPEC_K * np.mean(ticks):.2f} ms "
            f"({np.mean(rounds) / (SPEC_K * np.mean(ticks)):.2f}x); "
            f"{rep.generated_tokens / max(rep.spec_rounds, 1):.2f} tokens a "
            "round")
        for n, c in counts.items():
            out[n] = out.get(n, 0) + c
        del plain, spec
        torch.cuda.empty_cache()
    for cdt in (torch.bfloat16, *QUANT):
        verify_check(model, p0, fc, wl, cdt, dev,
                     f"verify bf16 {str(cdt)[6:]} pools (28 layers)",
                     exact=False)
    del p0, pn
    torch.cuda.empty_cache()

    # exactness in fp32 (TF32 off since the device phase) at 4 layers
    cfg4 = replace(cfg, num_layers=4, dtype="float32")
    model4 = build_model(cfg4)
    gen.manual_seed(4321)
    q0 = model4.init(gen, device=dev, weight_dtype=torch.float32)
    qn = noised_copy(q0, SPEC_NOISE_FP32, 98, dev)
    for label, peers in (("fp32 4 layers identical", [q0, q0]),
                         ("fp32 4 layers noised", [q0, qn])):
        plain, _rp, _c, _t, _w = serve_run(model4, peers, fc, wl,
                                           torch.float32, dev, label)
        spec, rep, _c, _r, _w = serve_run(model4, peers, fc, wl,
                                          torch.float32, dev, label,
                                          spec=SPEC_K)
        share = compare_streams(plain, spec, label)
        require(share == 1.0, f"{label}: speculative streams differ from "
                "plain decode in fp32")
        if peers[1] is qn:
            require(rep.spec_accept_rate < 1.0,
                    f"{label}: no draft was rejected")
    verify_check(model4, q0, fc, wl, torch.float32, dev,
                 "verify fp32 (4 layers)", exact=True)
    verify_check(model4, q0, replace(fc, fused_attention=False), wl,
                 torch.float32, dev, "verify fp32 gather (4 layers)",
                 exact=True)
    for qdt in QUANT:
        verify_check(model4, q0, fc, wl, qdt, dev,
                     f"verify fp32 {str(qdt)[6:]} pools (4 layers)",
                     exact=False)
    del q0, qn
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------------
# phase 13: the codistilled fleet (ensemble, canary, refresh, chaos)
# ----------------------------------------------------------------------------

# the async runtime's schedule for the fleet's snapshots: peer 1 dies at its
# step 2 for good, so its snapshot stays at step 2 while peer 0's reaches 4
CODIST_FAULTS = "fail=1@2"
# the fleet's chaos: peer 0 preempted after tick 6 for 120 ms, peer 1 dead at
# tick 10 and revived from its snapshot 40 ms later, peer 2 a 4x straggler
# over 30% of its ticks
FLEET_FAULTS = "straggler=2*4@0.3,preempt=0@6+120,fail=1@10"


def phase_fleet_codist(dev: torch.device):
    """qwen1.5-0.5b at full width and depth: the async runtime (2 peers,
    4 steps of 2 x 128 tokens, sgdm, snapshots every 2 steps, peer 1 failing
    at step 2) writes snapshots; 3 serving peers refresh from them
    (keep-last, a stale one dropped, the bytes billed); the ensemble policy
    with its canaries (row 8 on the prefill logits); a defended chaos run
    with a preemption, a failure revived from the async snapshot, a
    straggler and hedging; then the same policies in fp32 on the card and
    on the CPU (reduced config), whose reports must be equal. Every canary
    pair's mse is recomputed by row 8 and its plain version on the same
    (1, V) fp32 logits. Returns the ensemble run's launches (rows 1-4 and
    8)."""
    import tempfile

    from repro_torch.checkpoint.io import snapshot_meta
    from repro_torch.configs import CodistConfig, TrainConfig, get_config
    from repro_torch.core.comm_model import (bits_per_exchange_event,
                                             param_bits_of)
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.kernels import (fused_distill_loss,
                                     fused_distill_loss_plain, launch_counts,
                                     reset_launch_counts)
    from repro_torch.models import build_model
    from repro_torch.runtime import AsyncScheduler, parse_faults
    from repro_torch.serve.fleet import (ChaosConfig, FleetConfig,
                                         FleetDefense, FleetRouter,
                                         generate_workload)
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    task = MarkovLM(vocab=min(cfg.vocab_size, 512), seed=0,
                    effective_vocab=256)
    tc = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=4,
                     optimizer="sgdm")
    fc = FleetConfig(max_slots=16, block_size=16, num_blocks=1025,
                     max_blocks_per_slot=34, fused_attention=True)
    wl = generate_workload("bursty", 16, cfg.padded_vocab, seed=1,
                           max_prompt=256, max_new=16)
    peers = []
    for i in range(3):
        gen = torch.Generator(device=dev)
        gen.manual_seed(2024 + i)
        peers.append(model.init(gen, device=dev, weight_dtype=torch.bfloat16))
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        sched = AsyncScheduler(
            model, tc, CodistConfig(n_models=2),
            lambda step: make_lm_batch(task, 2, 128, step, None, seed=0,
                                       device=dev),
            parse_faults(CODIST_FAULTS, 2), checkpoint_dir=ckpt,
            checkpoint_every=2, staleness_bound=1, device=dev)
        sched.run()
        sync(dev)
        steps = [(snapshot_meta(ckpt, i) or {}).get("step") for i in range(2)]
        log(f"fleet_codist: the async runtime wrote snapshots at steps "
            f"{steps} in {time.perf_counter() - t0:.1f} s")
        require(steps == [4, 2], f"async snapshots at steps {steps}")

        # refresh: keep-last, a stale one dropped, the bytes billed
        router = FleetRouter(model, peers, config=fc, policy="ensemble",
                             snapshot_dir=ckpt, staleness_bound=1, device=dev)
        per = int(bits_per_exchange_event(
            "checkpoints", 2, b_model=param_bits_of(peers[0])) // 8)
        n1, n2 = router.refresh_now(), router.refresh_now()
        versions = [e.weights_version for e in router.engines]
        log(f"  refresh: {n1} then {n2} peers adopted, versions {versions}, "
            f"{router.refreshes_dropped_stale} stale drops, "
            f"{router.refresh_bytes} bytes billed ({per} a snapshot)")
        require((n1, n2, versions, router.refreshes_dropped_stale,
                 router.refresh_bytes) == (1, 0, [4, -1, -1], 2, per),
                "refresh: keep-last / staleness / billing")
        def same(a, b):
            if isinstance(a, dict):
                return all(same(a[k], b[k]) for k in a)
            return torch.equal(a, b.to(a.dtype))
        require(same(router.engines[0].params, sched.peers[0].state.params),
                "refresh: peer 0 does not hold its snapshot's weights")

        # the ensemble policy: every request on all 3 peers, 2 canary pairs
        # a request, each compared by distill_pair("mse") (row 8)
        sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = router.run(wl, slo_ms=50.0)
        sync(dev)
        wall = time.perf_counter() - t0
        out = {n: launch_counts[n]
               for n in ROWS_1_TO_4 + ("fused_distill_loss",)}
        log(f"  ensemble: completed {rep.completed}/{len(wl.requests)}, "
            f"canary {rep.canary}, {wall:.2f} s wall, launches {out}")
        require(rep.completed == len(wl.requests) and rep.lost_tokens == 0
                and rep.duplicated_tokens == 0, f"ensemble report {rep}")
        require(rep.canary["count"] == 2 * len(wl.requests)
                == out["fused_distill_loss"],
                f"canary pairs {rep.canary['count']}, row 8 launches "
                f"{out['fused_distill_loss']}")
        want = serve_launches(router, cfg.num_layers, 0, True, False)
        require({n: out[n] for n in want} == want,
                f"ensemble: rows 1-4 launched {out}, want {want}")
        require(rep.canary["mean_mse"] > 0 and math.isfinite(
            rep.canary["max_mse"]), f"canary {rep.canary}")
        # row 8 at the path's shape: every pair's prefill logits, (1, V)
        # fp32, through the kernel and its plain version
        errs, kern = {}, []
        for i, (prec, srec) in enumerate(router._pairs):
            a, b = (torch.as_tensor(r.prefill_logits, device=dev)[None]
                    for r in (prec, srec))
            kern.append(fused_distill_loss(a, b, "mse"))
            check_loss_output("fused_distill_loss", f"canary pair {i}",
                              kern[-1], fused_distill_loss_plain(a, b, "mse"),
                              False, True, errs)
        top = float(torch.cat(kern).max())
        log(f"  canary: {len(kern)} pairs' mse by row 8 held against the "
            f"plain version (fp32, 1e-5); the largest {top:.6f}")
        require(len(kern) == rep.canary["count"] and abs(
            top - rep.canary["max_mse"]) <= 1e-6 * top,
            f"canary: the report's max mse {rep.canary['max_mse']} is not "
            f"the kernel's {top}")
        del router
        torch.cuda.empty_cache()

        # chaos, defended, with hedging; peer 1 revives from its snapshot
        chaos = ChaosConfig(parse_faults(FLEET_FAULTS, 3, seed=0),
                            recover_after_ms=40.0)
        router = FleetRouter(model, peers, config=fc, cache_dtype=torch.bfloat16,
                             snapshot_dir=ckpt, chaos=chaos,
                             defense=FleetDefense(hedging=True), device=dev)
        t0 = time.perf_counter()
        rep = router.run(wl, slo_ms=50.0)
        sync(dev)
        log(f"  chaos: completed {rep.completed}/{len(wl.requests)}, lost "
            f"{rep.lost_tokens}, duplicated {rep.duplicated_tokens}, "
            f"migrations {rep.migrations}, hedges {rep.hedges} (wins "
            f"{rep.hedge_wins}), preemptions {rep.preemptions}, died / "
            f"recovered {rep.peers_died}/{rep.peers_recovered}, refresh bytes "
            f"{rep.refresh_bytes}, peer 1 version "
            f"{router.engines[1].weights_version}, p99 TTFT "
            f"{rep.p99_ttft_ms:.1f} ms (sim), {time.perf_counter() - t0:.2f} "
            "s wall")
        require(rep.completed == len(wl.requests) and rep.lost_tokens == 0
                and rep.duplicated_tokens == 0, "chaos: lost or duplicated")
        require(rep.preemptions >= 1 and rep.peers_died == 1
                and rep.peers_recovered == 1 and rep.hedges >= 1
                and router.engines[1].weights_version == 2,
                f"chaos: the faults or defenses did not all fire: {rep}")
        del router, sched
    del peers
    torch.cuda.empty_cache()
    codist_parity(dev)
    return out


def codist_parity(dev: torch.device) -> None:
    """Reduced qwen1.5-0.5b in fp32, the card against the CPU on the same
    weights, snapshots and workload: the ensemble policy, canaries every
    second request, weight refresh, chaos with hedging and speculative
    decoding; every ``FleetReport`` field equal (the canary's mse within
    1e-5 relative: the card's fused kernel sums in another order)."""
    import tempfile

    from repro_torch.checkpoint.io import save_snapshot
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.runtime import parse_faults
    from repro_torch.serve.fleet import (ChaosConfig, FleetConfig,
                                         FleetDefense, FleetRouter,
                                         SpecConfig, generate_workload)
    cfg = get_reduced("qwen1.5-0.5b")
    model = build_model(cfg)
    params = {"cpu": []}
    for i in range(3):
        gen = torch.Generator()
        gen.manual_seed(55 + i)
        params["cpu"].append(model.init(gen, device="cpu"))
    to_dev = lambda tree: ({k: to_dev(v) for k, v in tree.items()}  # noqa: E731
                           if isinstance(tree, dict) else tree.to(dev))
    params["card"] = [to_dev(p) for p in params["cpu"]]
    devices = {"cpu": torch.device("cpu"), "card": dev}
    wl = generate_workload("bursty", 12, cfg.padded_vocab, seed=4,
                           max_prompt=40, max_new=12)
    fc = FleetConfig(max_slots=3, block_size=4, num_blocks=64,
                     max_blocks_per_slot=16, max_prefills_per_step=1)
    with tempfile.TemporaryDirectory() as snap:
        save_snapshot(snap, 0, {"params": params["cpu"][2]}, meta={"step": 5})
        save_snapshot(snap, 1, {"params": params["cpu"][0]}, meta={"step": 3})
        cases = {
            "ensemble": dict(policy="ensemble"),
            "canary + refresh": dict(canary_every=2, snapshot_dir=snap,
                                     refresh_every_ms=5.0),
            "chaos + hedge": dict(
                chaos=ChaosConfig(parse_faults(FLEET_FAULTS, 3, seed=0),
                                  recover_after_ms=40.0),
                defense=FleetDefense(hedging=True, hedge_min_samples=3),
                snapshot_dir=snap),
            "speculative": dict(policy="speculative",
                                spec=SpecConfig(k=SPEC_K)),
        }
        for label, kw in cases.items():
            reps = {d: FleetRouter(model, params[d], config=fc,
                                   device=devices[d], **kw).run(wl).to_dict()
                    for d in devices}
            a, b = reps["cpu"], reps["card"]
            bad = {k: (a[k], b[k]) for k in a if k != "canary" and a[k] != b[k]}
            for ck, cv in a["canary"].items():
                cb = b["canary"][ck]
                if not (cv == cb or (ck in ("mean_mse", "max_mse")
                                     and abs(cv - cb) <= 1e-5 * abs(cv))):
                    bad[f"canary.{ck}"] = (cv, cb)
            log(f"  fp32 parity {label}: FleetReport card vs CPU "
                f"{len(a) - len(bad)}/{len(a)} fields equal (lost "
                f"{b['lost_tokens']}, duplicated {b['duplicated_tokens']}, "
                f"canary {b['canary']['count']}, refreshes {b['refreshes']}, "
                f"migrations {b['migrations']}, hedges {b['hedges']}, "
                f"spec rounds {b['spec_rounds']})")
            require(not bad, f"fp32 parity {label}: fields differ card vs "
                    f"CPU: {bad}")
            require(b["lost_tokens"] == 0 and b["duplicated_tokens"] == 0,
                    f"fp32 parity {label}: lost or duplicated tokens")


# ----------------------------------------------------------------------------
# phase 6: the standalone entries (rows 5 and 14)
# ----------------------------------------------------------------------------

def phase_ops(dev: torch.device):
    """``ops.cross_entropy_tokens`` on the training main path's logits
    (8 x 512 tokens, V=152064, bf16) and ``ops.attention`` at flash shapes
    a-c, launch counts set to 0 just before and read just after; outputs
    against the plain versions."""
    from repro_torch.kernels import (flash_attention_plain,
                                     fused_cross_entropy_plain, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels import ops
    x, _tg, lb, _g = loss_inputs(TRAIN_T, TRAIN_V, torch.bfloat16, dev, 600)
    del _tg
    attn = [(shape, flash_inputs(*shape[1:7], shape[9], dev, 700 + i))
            for i, shape in enumerate(FLASH_SHAPES) if shape[0] in TIMED_FLASH]
    sync(dev)
    reset_launch_counts()
    lead = (8, TRAIN_T // 8)                 # batch 8 x seq 512 per peer
    ce = ops.cross_entropy_tokens(x.view(*lead, TRAIN_V), lb.view(lead))
    outs = [ops.attention(q, k, v, causal=shape[7], window=shape[8])
            for shape, (q, k, v) in attn]
    sync(dev)
    counts = dict(launch_counts)
    require(counts["fused_cross_entropy"] == 1
            and counts["flash_attention"] == len(attn),
            f"ops launches {counts}")
    require(tuple(ce.shape) == lead and ce.dtype == torch.float32,
            f"cross_entropy_tokens shape {tuple(ce.shape)} {ce.dtype}")
    err = max_err(ce.reshape(-1), fused_cross_entropy_plain(x, lb))
    require(err <= 1e-5, f"ops.cross_entropy_tokens: {err:.3e} from plain")
    msg = [f"cross_entropy_tokens {lead} max|kernel-plain| {err:.3e}"]
    for (shape, (q, k, v)), o in zip(attn, outs):
        require(o.shape == q.shape and o.dtype == q.dtype,
                f"ops.attention {shape[0]}: {tuple(o.shape)} {o.dtype}")
        e = check_flash(f"ops {shape[0]}", o,
                        flash_attention_plain(q, k, v, shape[7], shape[8]),
                        shape[9])
        msg.append(f"attention {shape[0]} {e:.3e}")
    log("ops: " + "; ".join(msg) + f"; launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    del x, attn, outs
    torch.cuda.empty_cache()
    return {"fused_cross_entropy": counts["fused_cross_entropy"],
            "flash_attention": counts["flash_attention"]}


# ----------------------------------------------------------------------------
# phase 7: full-width codistillation training
# ----------------------------------------------------------------------------

LOSS_KERNELS = ("fused_cross_entropy_parts", "fused_cross_entropy_grad",
                "fused_ce_distill_parts", "fused_ce_distill_grad")


def run_steps(bundle, state, batches, steps: int, dev, first: int = 0):
    """``steps`` steps; returns (state, per-step metric floats, per-step
    wall ms). Each step ends in a device sync (the metrics are read)."""
    rows, walls = [], []
    for k in range(first, first + steps):
        b = batches(k)
        sync(dev)
        t0 = time.perf_counter()
        state, met, _plan = bundle.apply(state, b, k)
        vals = {m: float(met[m]) for m in ("loss", "task_loss",
                                           "distill_loss") if m in met}
        walls.append((time.perf_counter() - t0) * 1e3)
        rows.append(vals)
        require(all(math.isfinite(v) for v in vals.values()),
                f"step {k}: non-finite metrics {vals}")
    return state, rows, walls


def stamped(batches, dev):
    """Feed a training loop pre-made ``batches`` (a list), stamping the
    host clock as the loop asks for each: the loop takes batch k + 1 right
    after it has logged step k (reading the metrics syncs with the card),
    so consecutive stamps bracket one step. Returns (fn(k), stamps)."""
    sync(dev)
    stamps = []

    def fn(k):
        stamps.append(time.perf_counter())
        return batches[k]
    return fn, stamps


def finite_records(hist, name: str):
    """The per-step records of a History, each metric finite."""
    recs = [r for r in hist.records if "loss" in r]
    for r in recs:
        require(all(math.isfinite(v) for v in r.values()
                    if isinstance(v, float)),
                f"{name} step {r['step']}: non-finite metrics {r}")
    return recs


def phase_train(dev: torch.device):
    """qwen1.5-0.5b at full width and depth, fp32 master weights, bf16
    activations, through the training entry points ``train_codist`` and
    ``train_allreduce`` (weights from a seeded generator on the card): 2
    codistilling peers (mse, AdamW, cosine with warmup) for 10 steps at
    batch 8 x seq 512 per peer with a codist eval at steps 0 and 9, 2
    all-reduce steps and 2 codist steps with kl, launch counts checked per
    run; then the training CLI on the card (its reduced config)."""
    import contextlib
    import io

    from repro_torch.configs import CodistConfig, TrainConfig, get_config
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.train import (PredictionExchange, build_train_step,
                                   stack_batches, train_allreduce,
                                   train_codist)
    from repro_torch.tree import tree_leaves
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    b, s = TRAIN_T // 512, 512
    require(cfg.padded_vocab == TRAIN_V, f"padded vocab {cfg.padded_vocab}")
    task = MarkovLM(vocab=min(cfg.vocab_size, 512), seed=0,
                    effective_vocab=256)

    def lm_batch(step, seed=0):
        return make_lm_batch(task, b, s, step, None, seed=seed, device=dev)

    def codist_batches(steps, first=0):
        return [stack_batches([lm_batch(k)] * 2)
                for k in range(first, first + steps)]

    def counts():
        return {k: launch_counts[k] for k in LOSS_KERNELS}

    tc = TrainConfig(lr=1e-3, lr_schedule="cosine", warmup_steps=3,
                     total_steps=10, optimizer="adamw")
    launches = {}

    # ---- 10 codist steps, mse, with a codist eval at steps 0 and 9 ----
    cd = CodistConfig(n_models=2, distill_loss="mse")
    feed, stamps = stamped(codist_batches(10), dev)
    evals = codist_batches(1, first=10_000)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = train_codist(model, cd, tc, feed,
                               eval_batches=lambda k: evals[0], eval_every=9,
                               log_every=1, device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    launches["codist"] = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in tree_leaves(state.params[0]))
    log(f"train: qwen1.5-0.5b {cfg.num_layers} layers d_model {cfg.d_model} "
        f"V {cfg.padded_vocab}, {n_params / 1e6:.1f} M params per peer, 2 "
        f"peers, train_codist 10 steps in {wall:.1f} s (init and 2 evals "
        f"included)")
    recs = finite_records(hist, "codist mse")
    require([r["step"] for r in recs] == list(range(10)),
            f"codist History steps {[r['step'] for r in recs]}")
    # step k's wall: from the loop's request for batch k to that for k + 1
    # (steps 1-8: step 0 holds the init and an eval, step 9 an eval)
    walls = [(b1 - b0) * 1e3 for b0, b1 in zip(stamps[1:], stamps[2:])]
    for r in recs:
        w = walls[r["step"] - 1] if 1 <= r["step"] <= len(walls) else None
        log(f"  codist mse step {r['step']}: loss {r['loss']:.4f} task "
            f"{r['task_loss']:.4f} distill {r['distill_loss']:.5f}"
            + (f"  {w:.1f} ms wall" if w is not None else "")
            + (f"  eval loss {r['eval_loss']:.4f} accuracy "
               f"{r['eval_accuracy']:.4f}" if "eval_loss" in r else ""))
    step_ms = sum(walls) / len(walls)
    log(f"codist mse: {step_ms:.1f} ms wall per step (steps 1-8 of "
        f"train_codist, each ending in a sync), peak memory {peak:.1f} GiB, "
        f"comm_bytes {recs[-1]['comm_bytes']:.0f} over "
        f"{recs[-1]['comm_events']} exchanges, launches {launches['codist']}")
    require(recs[-1]["task_loss"] < recs[0]["task_loss"],
            f"codist task loss did not fall: {recs[0]['task_loss']} -> "
            f"{recs[-1]['task_loss']}")
    require(recs[-1]["comm_events"] == 10 and recs[-1]["comm_bytes"] > 0,
            f"codist exchanges {recs[-1]['comm_events']}, bytes "
            f"{recs[-1]['comm_bytes']}")
    require(all("eval_loss" in recs[k] for k in (0, 9)),
            "codist eval missing at steps 0 and 9")
    # rows 12 and 13 once per peer and step; row 6 once per peer and eval
    require(launches["codist"] == {"fused_cross_entropy_parts": 4,
                                   "fused_cross_entropy_grad": 0,
                                   "fused_ce_distill_parts": 20,
                                   "fused_ce_distill_grad": 20},
            f"codist launches {launches['codist']} != 2 x 10 of rows 12, 13 "
            "and 2 x 2 of row 6")
    # the device's busy share: 2 more steps of the same step function
    bundle = build_train_step(model, tc, cd, PredictionExchange(cd))
    fixed = codist_batches(1, first=10)[0]
    profile_device(lambda: bundle.apply(state, fixed, 10), step_ms, 2,
                   "step")
    del state, hist, bundle
    torch.cuda.empty_cache()

    # ---- 2 all-reduce steps ----
    tc2 = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=2,
                      optimizer="adamw")
    feed, stamps = stamped([lm_batch(k) for k in range(2)], dev)
    reset_launch_counts()
    state, hist = train_allreduce(model, tc2, (feed(k) for k in range(2)),
                                  log_every=1, device=dev)
    sync(dev)
    w1 = (time.perf_counter() - stamps[1]) * 1e3
    launches["allreduce"] = counts()
    recs = finite_records(hist, "allreduce")
    log(f"allreduce: task loss {[round(r['task_loss'], 4) for r in recs]}, "
        f"{w1:.1f} ms wall (step 1), launches {launches['allreduce']}")
    require(len(recs) == 2, f"allreduce History has {len(recs)} steps")
    require(launches["allreduce"] == {"fused_cross_entropy_parts": 2,
                                      "fused_cross_entropy_grad": 2,
                                      "fused_ce_distill_parts": 0,
                                      "fused_ce_distill_grad": 0},
            f"allreduce launches {launches['allreduce']} != 2 of rows 6, 7")
    del state, hist
    torch.cuda.empty_cache()

    # ---- 2 codist steps, kl ----
    cd_kl = CodistConfig(n_models=2, distill_loss="kl")
    feed, stamps = stamped(codist_batches(2), dev)
    reset_launch_counts()
    state, hist = train_codist(model, cd_kl, tc2, feed, log_every=1,
                               device=dev)
    sync(dev)
    w1 = (time.perf_counter() - stamps[1]) * 1e3
    launches["codist_kl"] = counts()
    recs = finite_records(hist, "codist kl")
    log(f"codist kl: loss {[round(r['loss'], 4) for r in recs]}, distill "
        f"{[round(r['distill_loss'], 6) for r in recs]}, {w1:.1f} ms wall "
        f"(step 1), launches {launches['codist_kl']}")
    require(len(recs) == 2, f"codist kl History has {len(recs)} steps")
    require(launches["codist_kl"]["fused_ce_distill_parts"] == 4
            and launches["codist_kl"]["fused_ce_distill_grad"] == 4,
            f"codist kl launches {launches['codist_kl']}")
    del state, hist
    torch.cuda.empty_cache()

    # ---- the training CLI on the card (its --reduced default) ----
    out = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        train_cli.main(["--device", "cuda", "--mode", "codist", "--steps",
                        "3", "--batch", "2", "--seq", "64", "--log-every",
                        "1", "--eval-every", "2"])
    lines = out.getvalue().splitlines()
    launches["cli"] = counts()
    log(f"training CLI (reduced, --device cuda): {lines[-1]}; launches "
        f"{launches['cli']}")
    require(len(lines) == 4 and lines[-1].startswith("done: 3 steps")
            and lines[-1].endswith("on cuda"), f"CLI output {lines}")
    require("nan" not in out.getvalue().lower(), f"CLI output {lines}")
    require(launches["cli"] == {"fused_cross_entropy_parts": 4,
                                "fused_cross_entropy_grad": 0,
                                "fused_ce_distill_parts": 6,
                                "fused_ce_distill_grad": 6},
            f"CLI launches {launches['cli']}")
    # the main path's launches: rows 12/13 and 6 from the codist run, rows
    # 6/7 added from the all-reduce run
    return {"fused_ce_distill_parts": launches["codist"]["fused_ce_distill_parts"],
            "fused_ce_distill_grad": launches["codist"]["fused_ce_distill_grad"],
            "fused_cross_entropy_parts":
                launches["codist"]["fused_cross_entropy_parts"]
                + launches["allreduce"]["fused_cross_entropy_parts"],
            "fused_cross_entropy_grad":
                launches["allreduce"]["fused_cross_entropy_grad"]}


# ----------------------------------------------------------------------------
# phase 8: the other exchanges and wires at full width
# ----------------------------------------------------------------------------

DISTILL_KERNELS = ("fused_distill_loss", "fused_distill_kl_parts",
                   "fused_distill_mse_grad", "fused_distill_kl_grad")
ALL_LOSS_KERNELS = LOSS_KERNELS + DISTILL_KERNELS


def expected_launches(n: int, mode: str, steps: int, *, combined: bool,
                      task_ce: bool, standalone: int, evals: int = 0) -> dict:
    """Loss-kernel launches of ``steps`` distilling steps of n peers, as
    ``codist_loss``'s loop makes them: per peer, the task CE (rows 6, 7)
    unless the first term is combined with it (rows 12, 13), and
    ``standalone`` further terms from rows 8 (mse) or 9 (kl) forward and 10
    or 11 backward; ``evals`` codist evals add row 6 once per peer."""
    per = n * steps
    out = dict.fromkeys(ALL_LOSS_KERNELS, 0)
    if combined:
        out["fused_ce_distill_parts"] = out["fused_ce_distill_grad"] = per
    if task_ce:
        out["fused_cross_entropy_parts"] = out["fused_cross_entropy_grad"] = per
    fwd = "fused_distill_loss" if mode == "mse" else "fused_distill_kl_parts"
    bwd = "fused_distill_mse_grad" if mode == "mse" else "fused_distill_kl_grad"
    out[fwd] = out[bwd] = standalone * per
    out["fused_cross_entropy_parts"] += n * evals
    return out


def phase_train_peers(dev: torch.device):
    """qwen1.5-0.5b at full width and depth, batch 8 x seq 512 per peer,
    AdamW, through ``train_codist`` with the exchanges and wires beyond
    PR-12's two-peer prediction exchange. Each run's launches are counted
    from 0 and checked per distilling step; returns the summed launches."""
    from repro_torch.configs import CodistConfig, TrainConfig, get_config
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, resolve_strategy,
                                   stack_batches, train_codist)
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    b, s = TRAIN_T // 512, 512
    task = MarkovLM(vocab=min(cfg.vocab_size, 512), seed=0,
                    effective_vocab=256)

    def batches(n, steps, first=0, coordinated=True):
        return [stack_batches([
            make_lm_batch(task, b, s, k, None if coordinated else g, seed=0,
                          device=dev) for g in range(n)])
            for k in range(first, first + steps)]

    total = dict.fromkeys(ALL_LOSS_KERNELS, 0)

    def run(name, cd, steps, want, eval_every=0, profile=False):
        """``steps`` steps of ``train_codist``; checks finite losses and the
        launches ``want``; returns the History's records."""
        tc = TrainConfig(lr=1e-3, lr_schedule="cosine", warmup_steps=2,
                         total_steps=steps, optimizer="adamw")
        feed, stamps = stamped(batches(cd.n_models, steps,
                                       coordinated=cd.mode == "predictions"),
                               dev)
        evals = batches(cd.n_models, 1, first=10_000)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        state, hist = train_codist(model, cd, tc, feed,
                                   eval_batches=lambda k: evals[0],
                                   eval_every=eval_every, log_every=1,
                                   device=dev)
        sync(dev)
        t_end = time.perf_counter()
        got = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        recs = finite_records(hist, name)
        require([r["step"] for r in recs] == list(range(steps)),
                 f"{name}: History steps {[r['step'] for r in recs]}")
        # step k's wall: from the loop's request for batch k to that for
        # k + 1 (each step ends in its metric read); the last step's to the
        # end of the run. Step 0 holds the init; an eval step is left out
        ends = stamps[2:] + [t_end]
        walls = [(e - s0) * 1e3 for k, (s0, e) in
                 enumerate(zip(stamps[1:], ends), start=1)
                 if "eval_loss" not in recs[k]]
        step_ms = sum(walls) / len(walls)
        for r in recs:
            log(f"  {name} step {r['step']}: loss {r['loss']:.4f} task "
                f"{r['task_loss']:.4f} distill {r['distill_loss']:.5f} alpha "
                f"{r['alpha']:.2f}" + (f"  eval loss {r['eval_loss']:.4f}"
                                       if "eval_loss" in r else ""))
        busy = None
        if profile:
            bundle = build_train_step(model, tc, cd, resolve_strategy(cd))
            fixed = batches(cd.n_models, 1, first=steps)[0]
            busy = profile_device(lambda: bundle.apply(state, fixed, steps),
                                  step_ms, 2, "step")
        log(f"{name}: {step_ms:.1f} ms wall per step (steps "
            f"{len(walls)} of {steps - 1} after the first"
            + (f", device busy {busy:.1f} ms = {busy / step_ms:.1%}"
               if busy else "") + f"), peak memory {peak:.1f} GiB, comm "
            f"events {recs[-1]['comm_events']} bytes "
            f"{recs[-1]['comm_bytes']:.0f}, launches "
            f"{ {k: v for k, v in got.items() if v} }")
        require(got == want, f"{name}: launches {got} != {want}")
        for k in ALL_LOSS_KERNELS:
            total[k] += got[k]
        del state, hist
        return recs

    # (a) three peers, mse: the first term combined (rows 12/13), the
    # second from rows 8/10; then two kl steps (rows 9/11)
    log(f"train_peers: qwen1.5-0.5b {cfg.num_layers} layers d_model "
        f"{cfg.d_model} V {cfg.padded_vocab}, batch {b} x seq {s} per peer")
    recs = run("(a) 3 peers mse", CodistConfig(n_models=3), 6,
               expected_launches(3, "mse", 6, combined=True, task_ce=False,
                                 standalone=1, evals=2),
               eval_every=5, profile=True)
    require(recs[-1]["task_loss"] < recs[0]["task_loss"],
            f"(a) task loss did not fall: {recs[0]['task_loss']} -> "
            f"{recs[-1]['task_loss']}")
    run("(a) 3 peers kl", CodistConfig(n_models=3, distill_loss="kl"), 2,
        expected_launches(3, "kl", 2, combined=True, task_ce=False,
                          standalone=1))
    # (b) a subsample wire of 64 of 512 tokens: task CE (rows 6/7) and the
    # term from rows 8-11 on the subsampled tokens
    for mode in ("mse", "kl"):
        run(f"(b) subsample 64 {mode}",
            CodistConfig(n_models=2, distill_loss=mode,
                         compression="subsample", subsample=64), 2,
            expected_launches(2, mode, 2, combined=False, task_ce=True,
                              standalone=1))
    # (c) the checkpoint exchange: own batches, stale replicas refreshed at
    # steps 0 and 2
    recs = run("(c) checkpoint period 2",
               CodistConfig(n_models=2, mode="checkpoints", period=2), 3,
               expected_launches(2, "mse", 3, combined=True, task_ce=False,
                                 standalone=0))
    require([r["comm_events"] for r in recs] == [1, 1, 2],
            f"(c) exchanges {[r['comm_events'] for r in recs]}")
    # (d) the pipelined exchange: task CE on the batch, the combined kernel
    # on the replayed previous batch; no valid targets at step 0
    recs = run("(d) pipelined", CodistConfig(n_models=2, pipelined=True), 3,
               expected_launches(2, "mse", 3, combined=True, task_ce=True,
                                 standalone=0))
    require(recs[0]["alpha"] == 0.0 and recs[1]["alpha"] > 0.0,
            f"(d) alpha {[r['alpha'] for r in recs]}")
    # (e) a top-k wire: the task CE fused (rows 6/7), the term plain torch
    run("(e) topk 64", CodistConfig(n_models=2, compression="topk", topk=64),
        2, expected_launches(2, "mse", 2, combined=False, task_ce=True,
                             standalone=0))
    torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------------------
# phase 9: the paper-grid harness at full width
# ----------------------------------------------------------------------------

# model_overrides that turn the runner's get_reduced("qwen1.5-0.5b") back
# into the full config (the phase requires the two equal)
FULL_OVERRIDES = {"num_layers": 24, "d_model": 1024, "num_heads": 16,
                  "num_kv_heads": 16, "d_ff": 2816, "vocab_size": 151936,
                  "head_dim": 0, "dtype": "bfloat16",
                  "max_position": 1048576}
SWEEP_STEPS = 10
SWEEP_MODES = ["allreduce", "codist", "codist-ckpt", "codist-pipelined",
               "codist-async"]
# the async runtime's fault schedule (phase async and train_parity): peer 1
# straggles 3x over half its steps and is preempted for 3 s after step 2,
# peer 0 dies at step 4 and recovers from its snapshot, a third peer joins
# at 2.5 s
ASYNC_FAULTS = "straggler=1*3@0.5,preempt=1@2+3,fail=0@4"
ASYNC_JOIN = 2.5
ASYNC_LAYERS = 12
ASYNC_KW = dict(staleness_bound=1, checkpoint_every=2, recover_after=2.0,
                join_burn_in=2)


def sweep_expected(mode: str, burn: int, steps: int, n: int = 2) -> dict:
    """Loss-kernel launches of one mse sweep cell of n peers: all-reduce,
    the CE a step (rows 6, 7); the prediction exchange, the CE per peer
    during burn-in and the combined kernel after (rows 12, 13); the
    checkpoint exchange, the combined kernel every step (burn-in only
    zeroes alpha); the pipelined exchange, the CE and the combined kernel
    every step; the async peers, the CE every step and one distillation
    term (rows 8, 10) per distilling step (one target slot)."""
    out = dict.fromkeys(ALL_LOSS_KERNELS, 0)

    def add(names, k):
        for name in names:
            out[name] += k
    ce = ("fused_cross_entropy_parts", "fused_cross_entropy_grad")
    comb = ("fused_ce_distill_parts", "fused_ce_distill_grad")
    if mode == "allreduce":
        add(ce, steps)
    elif mode == "codist":
        add(ce, n * burn)
        add(comb, n * (steps - burn))
    elif mode == "codist-ckpt":
        add(comb, n * steps)
    elif mode == "codist-pipelined":
        add(ce, n * steps)
        add(comb, n * steps)
    else:
        add(ce, n * steps)
        add(("fused_distill_loss", "fused_distill_mse_grad"), n * (steps - burn))
    return out


def phase_sweep(dev: torch.device):
    """The paper-grid harness at qwen1.5-0.5b's full width and depth: a
    spec written as YAML and loaded through ``load_spec`` (batch 8 x seq
    512 a peer, 10 steps, cosine 1e-3, mse, 2 peers, the five modes under
    a constant and a burn-in alpha: 9 cells), run through
    ``repro_torch.launch.sweep.main`` on the card, then again with
    ``--resume`` (every cell skipped, no kernel launched). Per cell: the
    task loss finite and falling, the launches of its mode's loss loop,
    the async wire bytes times its deliveries; wall seconds, ms per step
    (ms per peer step for async) after step 0, host ms a step in batch
    making, peak memory. Then the aggregate's gap and bytes-to-quality
    columns and codist steps/s per card. Returns the summed launches."""
    import contextlib
    import io
    import tempfile

    import yaml

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.experiments import load_spec, runner
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import sweep as sweep_cli
    from repro_torch.train import History
    arch = "qwen1.5-0.5b"
    full = get_config(arch)
    require(replace(get_reduced(arch), **FULL_OVERRIDES) == full,
            "the sweep's model_overrides do not restore get_config")
    doc = {"name": "chip_sweep", "arch": arch, "seq_len": 512,
           "steps": SWEEP_STEPS, "optimizer": "adamw", "distill_loss": "mse",
           "seeds": [0], "batch_sizes": [TRAIN_T // 512],
           "lr_schedules": [{"name": "cos1e3", "kind": "cosine", "lr": 1e-3,
                             "warmup_frac": 0.1}],
           "modes": SWEEP_MODES,
           "alpha_schedules": [{"name": "const", "alpha0": 1.0},
                               {"name": "burnin", "alpha0": 1.0,
                                "burn_in_frac": 0.25}],
           "peers": [2], "model_overrides": FULL_OVERRIDES}
    # instrument the runner: each cell's wall, launches and peak, and the
    # host clock at each step's first batch request (the loops request
    # batch k + 1 right after logging step k, which syncs)
    run_cell, make_batch = runner.run_cell, runner.make_lm_batch
    stats, cur = {}, {}

    def stamped_batch(task, batch, seq_len, step, group=None, seed=0,
                      device="cuda"):
        t0 = time.perf_counter()
        cur["stamps"].setdefault(step, t0)
        out = make_batch(task, batch, seq_len, step, group, seed=seed,
                         device=device)
        cur["batch_s"] += time.perf_counter() - t0
        return out

    def timed_run_cell(cell, steps=None, **kw):
        cur.update(stamps={}, batch_s=0.0)
        before = dict(launch_counts)
        sync(dev)
        t0 = time.perf_counter()
        summary, hist = run_cell(cell, steps, **kw)
        sync(dev)
        t1 = time.perf_counter()
        stats[cell.cell_id] = {
            "wall": t1 - t0, "end": t1, "stamps": cur["stamps"],
            "batch_s": cur["batch_s"],
            "peak": torch.cuda.max_memory_allocated(dev) / 2**30,
            "launches": {k: launch_counts[k] - before[k]
                         for k in ALL_LOSS_KERNELS}}
        return summary, hist

    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, "chip_sweep.yaml")
        with open(spec_path, "w") as f:
            yaml.safe_dump(doc, f)
        spec = load_spec(spec_path)
        cells = spec.cells()
        require(len(cells) == 9, f"{len(cells)} cells, not 9")
        argv = ["--spec", spec_path, "--out", tmp, "--device", dev.type]
        runner.run_cell, runner.make_lm_batch = timed_run_cell, stamped_batch
        try:
            out = io.StringIO()
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = sweep_cli.main(argv)
            wall = time.perf_counter() - t0
            launches = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
            for line in out.getvalue().splitlines():
                log(f"  {line}")
            require(rc == 0 and "ran=9 skipped=0 failed=0" in out.getvalue()
                    and "aggregated 9 cells" in out.getvalue(),
                    f"sweep exit {rc}")
            out = io.StringIO()
            reset_launch_counts()
            with contextlib.redirect_stdout(out):
                rc = sweep_cli.main(argv + ["--resume"])
            resumed = {k: v for k, v in launch_counts.items() if v}
            log("sweep --resume: " + next(
                line for line in out.getvalue().splitlines()
                if line.startswith(f"sweep {spec.name}:")))
            require(rc == 0 and "ran=0 skipped=9 failed=0" in out.getvalue(),
                    f"--resume exit {rc}: {out.getvalue()}")
            require(not resumed, f"--resume launched {resumed}")
        finally:
            runner.run_cell, runner.make_lm_batch = run_cell, make_batch
        sweep_dir = os.path.join(tmp, spec.name)
        with open(os.path.join(sweep_dir, f"SWEEP_{spec.name}.json")) as f:
            agg = json.load(f)
        wire_bytes = TRAIN_T * full.padded_vocab * 4
        step_ms = {}
        log(f"sweep: {len(cells)} cells in {wall:.1f} s; per cell (qwen1.5-0.5b "
            f"full width, batch 8 x seq 512 a peer, {SWEEP_STEPS} steps):")
        for cell in cells:
            st = stats[cell.cell_id]
            recs = finite_records(History.load(
                os.path.join(sweep_dir, f"{cell.cell_id}.jsonl")),
                cell.cell_id)
            with open(os.path.join(sweep_dir, f"{cell.cell_id}.json")) as f:
                final = json.load(f)["final"]
            burn = int(round(cell.alpha.burn_in_frac * SWEEP_STEPS))
            for p in sorted({r.get("peer", 0) for r in recs}):
                mine = [r for r in recs if r.get("peer", 0) == p]
                require([r["step"] for r in mine] == list(range(SWEEP_STEPS)),
                        f"{cell.cell_id} peer {p}: steps "
                        f"{[r['step'] for r in mine]}")
                require(mine[-1]["task_loss"] < mine[0]["task_loss"],
                        f"{cell.cell_id} peer {p}: task loss did not fall "
                        f"{mine[0]['task_loss']} -> {mine[-1]['task_loss']}")
            want = sweep_expected(cell.mode, burn, SWEEP_STEPS)
            require(st["launches"] == want,
                    f"{cell.cell_id}: launches {st['launches']} != {want}")
            n = cell.peers if cell.mode == "codist-async" else 1
            if cell.mode == "codist-async":
                n_on = sum(1 for r in recs if r["peer_weight"] > 0)
                require(n_on == cell.peers * (SWEEP_STEPS - burn)
                        and final["comm_events"] == n_on
                        and final["comm_bytes"] == wire_bytes * n_on,
                        f"{cell.cell_id}: {n_on} deliveries, comm "
                        f"{final['comm_events']} events "
                        f"{final['comm_bytes']} bytes (wire {wire_bytes})")
            ms = (st["end"] - st["stamps"][1]) * 1e3 / (n * (SWEEP_STEPS - 1))
            step_ms[cell.cell_id] = ms
            unit = "peer step" if n > 1 else "step"
            log(f"  {cell.cell_id}: {st['wall']:.2f} s wall, {ms:.1f} ms per "
                f"{unit} after step 0, batch making "
                f"{st['batch_s'] * 1e3 / (n * SWEEP_STEPS):.1f} ms host a "
                f"{unit}, "
                f"peak {st['peak']:.2f} GiB, task loss "
                f"{recs[0]['task_loss']:.4f} -> {final['task_loss']:.4f}, "
                f"comm {final['comm_events']} events "
                f"{final['comm_bytes']:.0f} bytes, launches "
                f"{ {k: v for k, v in st['launches'].items() if v} }")
        log("sweep aggregate (final loss = mean over seeds; gap = codist - "
            "allreduce at the same batch and LR; bytes->Q = comm bytes "
            "when the task loss first reached Q x the baseline's):")
        for r in agg["grid"]:
            gap = r["gap_vs_allreduce"]
            log(f"  {r['mode']:16s} alpha {r['alpha']:6s} final "
                f"{r['final_loss_mean']:.4f} gap "
                + ("-" if gap is None else f"{gap:+.4f}")
                + f" comm {r['comm_bytes_mean']:.0f} bytes->Q "
                f"{r['bytes_to_quality']}")
        for cell in cells:
            if cell.mode == "allreduce":
                continue
            # an async step: one local step of each peer
            n = cell.peers if cell.mode == "codist-async" else 1
            log(f"codist steps/s per card, {cell.cell_id}: "
                f"{1e3 / (step_ms[cell.cell_id] * n):.3f}")
    return launches


# ----------------------------------------------------------------------------
# phase 10: the async runtime at full width
# ----------------------------------------------------------------------------

def phase_async(dev: torch.device):
    """The async runtime at qwen1.5-0.5b's full width and 12 of its 24
    layers (``ASYNC_LAYERS``), through
    ``AsyncScheduler`` (batch 8 x seq 512 a peer): 2 peers and an elastic
    join, kl distillation, 5 steps under ``ASYNC_FAULTS`` with snapshots
    every 2 steps, recovery 2 s after a failure and a staleness bound of 1.
    Checks the failed peer's restore, finite histories, staleness within
    the bound and rows 6, 7, 9, 11 as the distilling steps imply; prints ms
    per peer step and per publish forward, the device-busy share of two
    scheduler rounds (torch.profiler), peak memory, sim_time and
    comm_bytes. Then the training CLI in ``codist-async`` with the same
    fault flags and ``--out`` on the card (its reduced config). Returns the
    main run's launches."""
    import contextlib
    import io
    import tempfile

    from repro_torch.configs import CodistConfig, TrainConfig, get_config
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.runtime import AsyncScheduler, parse_faults
    from repro_torch.runtime.peer import PeerRuntime
    from repro_torch.train import History
    # full width at 12 of its 24 layers: the depth cut keeps the whole
    # script near its time budget since the spec and fleet_codist phases
    # came in (a snapshot of the peer state, fp32 params + AdamW m and v, is
    # host I/O of 3.7 GB instead of 5.6)
    cfg = replace(get_config("qwen1.5-0.5b"), num_layers=ASYNC_LAYERS)
    model = build_model(cfg)
    # 5 steps: each snapshot of a peer state took ~13 s of host I/O at full
    # depth on the H100 machine, so the phase keeps 6 of them and the one
    # restore (peer 0 fails at its step 4, after its step-4 snapshot)
    b, s, steps = TRAIN_T // 512, 512, 5
    task = MarkovLM(vocab=min(cfg.vocab_size, 512), seed=0,
                    effective_vocab=256)

    def batches(step):
        return make_lm_batch(task, b, s, step, None, seed=0, device=dev)

    faults = replace(parse_faults(ASYNC_FAULTS, 2), joins=((2, ASYNC_JOIN),))
    tc = TrainConfig(lr=1e-3, lr_schedule="cosine", warmup_steps=2,
                     total_steps=steps, optimizer="adamw")
    cd = CodistConfig(n_models=2, distill_loss="kl")
    # time the snapshots and restores (host I/O of a peer state)
    io_s = {"snapshot": [0, 0.0], "restore": [0, 0.0]}
    orig = {name: getattr(PeerRuntime, name) for name in io_s}

    def timed(name):
        def fn(self, *a, **kw):
            t0 = time.perf_counter()
            orig[name](self, *a, **kw)
            io_s[name][0] += 1
            io_s[name][1] += time.perf_counter() - t0
        return fn

    with tempfile.TemporaryDirectory() as ckpt:
        for name in io_s:
            setattr(PeerRuntime, name, timed(name))
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            sched = AsyncScheduler(model, tc, cd, batches, faults,
                                   checkpoint_dir=ckpt, device=dev,
                                   **ASYNC_KW)
            sync(dev)
            t_init = time.perf_counter()
            report = sched.run()
            sync(dev)
            t_end = time.perf_counter()
            launches = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            for name, fn in orig.items():
                setattr(PeerRuntime, name, fn)
    recs = []
    for p in sorted(report.histories):
        mine = finite_records(report.histories[p], f"async peer {p}")
        log(f"  async peer {p}: steps {[r['step'] for r in mine]}, task "
            f"{mine[0]['task_loss']:.4f} -> {mine[-1]['task_loss']:.4f}, "
            f"staleness {[round(r['staleness'], 2) for r in mine]}, "
            f"sim_time {[r['sim_time'] for r in mine]}")
        recs += mine
    n_on = sum(1 for r in recs if r["peer_weight"] > 0)
    stale = report.staleness
    io_total = io_s["snapshot"][1] + io_s["restore"][1]
    step_ms = (t_end - t_init - io_total) * 1e3 / len(recs)
    log(f"async: 3 peers (2 + a join at {ASYNC_JOIN} s), {len(recs)} peer "
        f"steps ({n_on} distilling) in {t_end - t_init:.1f} s after a "
        f"{t_init - t0:.1f} s init; {io_s['snapshot'][0]} snapshots in "
        f"{io_s['snapshot'][1]:.1f} s, {io_s['restore'][0]} restore in "
        f"{io_s['restore'][1]:.1f} s; {step_ms:.1f} ms wall per peer step "
        f"without them (publishes included); peak {peak:.2f} GiB; "
        f"sim_time {report.sim_time} comm_events {report.comm_events} "
        f"comm_bytes {report.comm_bytes:.0f}; staleness {stale}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    require(io_s["restore"][0] == 1 and sorted(report.completion) == [0, 1, 2],
            f"restores {io_s['restore'][0]}, completion {report.completion}")
    require(stale["payloads_accepted"] > 0 and stale["staleness_max"] <= 1
            and stale["staleness_mean"] <= stale["staleness_max"]
            and all(r["staleness"] <= 1 for r in recs),
            f"staleness {stale} against a bound of 1")
    want = dict.fromkeys(ALL_LOSS_KERNELS, 0)
    want["fused_cross_entropy_parts"] = want["fused_cross_entropy_grad"] = len(recs)
    # one kl term per target slot (2: two other peers) per distilling step
    want["fused_distill_kl_parts"] = want["fused_distill_kl_grad"] = 2 * n_on
    require(launches == want, f"async launches {launches} != {want}")
    require(report.comm_bytes > 0 and report.comm_events == n_on,
            f"async comm {report.comm_events} events, {n_on} distilling")

    # a publish forward alone, and the device's busy share of two rounds
    # of every peer (publish, then step) past the run's end
    params, batch = sched.peers[0].state.params, sched._batch(0)
    sched._publish(params, batch)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        sched._publish(params, batch)
    sync(dev)
    pub_ms = (time.perf_counter() - t0) * 1e3 / 3
    sched.checkpoint_every = 0
    live = sorted(sched.peers)

    def one_round():
        for p in live:
            pr = sched.peers[p]
            sched.mailbox.post(p, pr.step, 0.0, sched._publish(
                pr.state.params, sched._batch(pr.step)))
        for p in live:
            sched._step_peer(sched.peers[p], 0.0)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(2):
        one_round()
    sync(dev)
    round_ms = (time.perf_counter() - t0) * 1e3 / 2
    log(f"async: {pub_ms:.1f} ms wall per publish forward (fp32 wire of "
        f"{TRAIN_T} x {cfg.padded_vocab}), {round_ms:.1f} ms wall per round "
        f"of 3 peers ({round_ms / 3:.1f} a peer step)")
    profile_device(one_round, round_ms, 2, "round")
    del sched, report, params, batch
    torch.cuda.empty_cache()

    # ---- the CLI on the card (its reduced config) ----
    with tempfile.TemporaryDirectory() as out_dir:
        out = io.StringIO()
        reset_launch_counts()
        with contextlib.redirect_stdout(out):
            train_cli.main(["--device", dev.type, "--mode", "codist-async",
                            "--steps", "6", "--batch", "2", "--seq", "64",
                            "--log-every", "1", "--faults", ASYNC_FAULTS,
                            "--elastic", str(ASYNC_JOIN),
                            "--staleness-bound", "1", "--join-burn-in", "2",
                            "--checkpoint-every", "2", "--recover-after",
                            "2", "--distill-loss", "kl", "--out", out_dir])
        lines = out.getvalue().splitlines()
        cli = {k: v for k, v in launch_counts.items() if v}
        log(f"training CLI codist-async (reduced, --device {dev.type}): "
            f"{lines[-3]}; {lines[-2]}; launches {cli}")
        require(lines[-2].startswith("done: 6 steps x 3 peers")
                and lines[-2].endswith(f"on {dev.type}")
                and lines[-3].startswith("sim_time="),
                f"CLI output {lines[-4:]}")
        require("nan" not in out.getvalue().lower(), f"CLI output {lines}")
        for p in range(3):
            h = History.load(os.path.join(out_dir, f"peer{p}.jsonl"))
            require(h.last("step") == 5, f"CLI peer {p} history")
            for name in (f"final_peer{p}.npz",
                         os.path.join("runtime_ckpt", f"peer{p}.npz")):
                require(os.path.exists(os.path.join(out_dir, name)),
                        f"CLI wrote no {name}")
        require(cli.get("fused_distill_kl_parts", 0) > 0
                and cli.get("fused_cross_entropy_grad", 0) > 0,
                f"CLI launches {cli}")
    return launches


# ----------------------------------------------------------------------------
# phase 11: fp32 training, card vs CPU
# ----------------------------------------------------------------------------

def phase_train_parity(dev: torch.device):
    """Reduced qwen1.5-0.5b in fp32 (TF32 off): the same weights and
    batches train 3 codist steps on the card (the kernels) and on the CPU
    (their plain versions): 2 peers mse and kl, 3 peers mse (rows 8/10), a
    subsample wire (rows 6-11), the checkpoint and the pipelined exchange;
    per-step losses within 1e-4 relative, card launches as
    ``codist_loss``'s loop makes them. Then the async runtime: at
    staleness bound 0 on a clean schedule against the sync prediction
    exchange, both on the card (rows 6-8, 10 against rows 12, 13), and
    under ``ASYNC_FAULTS`` card against CPU (equal simulated clock, comm
    and staleness fields); per-step losses within 1e-4 relative."""
    from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (build_train_step, resolve_strategy,
                                   stack_batches)
    from repro_torch.train.state import CodistState, trainable_params
    from repro_torch.tree import tree_map
    cfg = get_reduced("qwen1.5-0.5b")
    model = build_model(cfg)
    task = MarkovLM(vocab=min(cfg.vocab_size, 512), seed=1,
                    effective_vocab=256)
    gen = torch.Generator()
    gen.manual_seed(5)
    init = [model.init(gen, device="cpu") for _ in range(3)]
    C = CodistConfig
    cases = [  # name, config, expected card launches of 3 steps
        ("mse", C(n_models=2), expected_launches(
            2, "mse", 3, combined=True, task_ce=False, standalone=0)),
        ("kl", C(n_models=2, distill_loss="kl"), expected_launches(
            2, "kl", 3, combined=True, task_ce=False, standalone=0)),
        ("3 peers mse", C(n_models=3), expected_launches(
            3, "mse", 3, combined=True, task_ce=False, standalone=1)),
        ("subsample 16 kl", C(n_models=2, distill_loss="kl",
                              compression="subsample", subsample=16),
         expected_launches(2, "kl", 3, combined=False, task_ce=True,
                           standalone=1)),
        ("checkpoint", C(n_models=2, mode="checkpoints", period=2),
         expected_launches(2, "mse", 3, combined=True, task_ce=False,
                           standalone=0)),
        ("pipelined", C(n_models=2, pipelined=True), expected_launches(
            2, "mse", 3, combined=True, task_ce=True, standalone=0)),
    ]
    worst = 0.0
    for name, cd, want in cases:
        n = cd.n_models
        coordinated = cd.mode == "predictions"
        batches = [stack_batches([
            make_lm_batch(task, 4, 64, k, None if coordinated else g, seed=1,
                          device="cpu") for g in range(n)]) for k in range(3)]
        tc = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=3,
                         optimizer="adamw", label_smoothing=0.1,
                         fused_losses=True)
        losses = {}
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            feed = [{k: v.to(d) for k, v in b.items()} for b in batches]
            params = trainable_params(tree_map(
                lambda p: p.detach().clone().to(d), init[:n]))
            opt_init, _ = make_optimizer(tc.optimizer)
            strategy = resolve_strategy(cd)
            state = strategy.ensure_state(
                CodistState(params, opt_init(params), 0), model, tc, feed[0])
            bundle = build_train_step(model, tc, cd, strategy)
            reset_launch_counts()
            state, rows, _w = run_steps(bundle, state, lambda k: feed[k], 3,
                                        d)
            losses[where] = rows
            if where == "card":
                got = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
                require(got == want, f"card parity {name} launches {got} != "
                        f"{want}")
        for k, (a, c) in enumerate(zip(losses["cpu"], losses["card"])):
            for m in a:
                rel = abs(c[m] - a[m]) / max(abs(a[m]), 1e-12)
                worst = max(worst, rel)
                require(rel <= 1e-4, f"train parity {name} step {k} {m}: "
                        f"card {c[m]} vs cpu {a[m]} (rel {rel:.2e})")
        log(f"train parity {name}: card vs CPU per-step loss, 3 steps: "
            + "; ".join(f"{a['loss']:.6f}/{c['loss']:.6f}"
                        for a, c in zip(losses["cpu"], losses["card"])))
    log(f"train parity: worst relative difference {worst:.2e} (tol 1e-4)")
    async_parity(dev, model, task, init)


def async_parity(dev: torch.device, model, task, init) -> None:
    """The async runtime in fp32 at the reduced size of ``phase_train_parity``
    (its model, task and CPU-drawn initial trees ``init``)."""
    import tempfile

    from repro_torch.configs import CodistConfig, TrainConfig
    from repro_torch.data import make_lm_batch
    from repro_torch.runtime import AsyncScheduler, FaultConfig, parse_faults
    from repro_torch.train import stack_batches, train_codist
    from repro_torch.tree import tree_map

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    # (a) bound 0, clean: the async peers against the sync exchange
    steps = 4
    tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=steps,
                     optimizer="adamw")
    cd = CodistConfig(n_models=2)
    feed = [make_lm_batch(task, 4, 64, k, None, seed=1, device=dev)
            for k in range(steps)]
    rep = AsyncScheduler(model, tc, cd, lambda k: feed[k],
                         FaultConfig(n_peers=2, seed=0), staleness_bound=0,
                         device=dev).run()
    _, hist = train_codist(model, cd, tc,
                           lambda k: stack_batches([feed[k]] * 2),
                           log_every=1, device=dev)
    worst = 0.0
    for p in (0, 1):
        for key in ("task_loss", "distill_loss"):
            got = rep.histories[p].series(key)
            want = hist.series(f"{key}_per_model_{p}")
            require(len(got) == len(want) == steps, f"async s0 {key} {got}")
            for k, (a, w) in enumerate(zip(got, want)):
                worst = max(worst, rel(a, w))
                require(rel(a, w) <= 1e-4, f"async s0 peer {p} step {k} "
                        f"{key}: async {a} vs sync {w}")
    log(f"train parity async s0 vs sync exchange (card, {steps} steps): "
        f"worst relative difference {worst:.2e} (tol 1e-4)")

    # (b) the fault schedule, card against CPU, from the same CPU-drawn
    # trees (a joiner takes init[2])
    class Seeded(AsyncScheduler):
        def _init_params(self):
            return [tree_map(lambda x: x.clone().to(self.device), t)
                    for t in init[:2]]

        def _join_params(self, pid):
            return tree_map(lambda x: x.clone().to(self.device), init[pid])

    steps = 8
    tc = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=steps,
                     optimizer="adamw")
    cd = CodistConfig(n_models=2, distill_loss="kl")
    faults = replace(parse_faults(ASYNC_FAULTS, 2), joins=((2, ASYNC_JOIN),))
    batches = [make_lm_batch(task, 4, 64, k, None, seed=1, device="cpu")
               for k in range(steps)]
    reps = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        fd = [{k: v.to(d) for k, v in b.items()} for b in batches]
        with tempfile.TemporaryDirectory() as ckpt:
            reps[where] = Seeded(model, tc, cd, lambda k, fd=fd: fd[k], faults,
                                 checkpoint_dir=ckpt, device=d,
                                 **ASYNC_KW).run()
    a, c = reps["cpu"], reps["card"]
    for field in ("sim_time", "time_to_first", "completion", "comm_events",
                  "comm_bytes", "staleness"):
        require(getattr(a, field) == getattr(c, field),
                f"async card vs CPU {field}: {getattr(c, field)} vs "
                f"{getattr(a, field)}")
    worst = 0.0
    for p in a.histories:
        ra, rc = a.histories[p].records, c.histories[p].records
        require([r["step"] for r in ra] == [r["step"] for r in rc],
                f"async card vs CPU peer {p} steps")
        for x, y in zip(ra, rc):
            for key in ("loss", "task_loss", "distill_loss"):
                worst = max(worst, rel(y[key], x[key]))
                require(rel(y[key], x[key]) <= 1e-4, f"async card vs CPU "
                        f"peer {p} step {x['step']} {key}: {y[key]} vs "
                        f"{x[key]}")
    log(f"train parity async under faults (card vs CPU, {steps} steps, "
        f"sim_time {c.sim_time}, comm {c.comm_events} events "
        f"{c.comm_bytes:.0f} bytes, staleness {c.staleness}): worst "
        f"relative difference {worst:.2e} (tol 1e-4)")


# ----------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi_line = phase_device()
    if "build" in phases:
        phase_build()
    kernel_rows = {}
    if "kernels" in phases:
        t0 = time.perf_counter()
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
        kernel_rows = phase_scatter_kernels(dev, flush)
        kernel_rows.update(phase_kernels(dev, flush))
        kernel_rows.update(phase_quant_kernels(dev, flush))
        verify = phase_verify_kernels(dev, flush)
        kernel_rows["paged_attention_decode"].update(
            {f"verify_{k}": v for k, v in verify.items()
             if k in ("ms", "plain_ms", "library_ms", "bound_ms")})
        kernel_rows.update(phase_ops_kernels(dev, flush))
        kernel_rows.update(phase_loss_kernels(dev, flush))
        kernel_rows.update(phase_distill_kernels(dev, flush))
        del flush
        log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    launches = {}          # path -> {kernel: launches on that path's run}
    if "fleet" in phases:
        t0 = time.perf_counter()
        launches["fleet"] = phase_fleet(dev, get_config("qwen2-7b"))
        torch.cuda.empty_cache()
        log(f"phase fleet: {time.perf_counter() - t0:.1f} s")
    if "parity" in phases:
        t0 = time.perf_counter()
        phase_parity(dev)
        log(f"phase parity: {time.perf_counter() - t0:.1f} s")
    if "ops" in phases:
        t0 = time.perf_counter()
        launches["ops"] = phase_ops(dev)
        log(f"phase ops: {time.perf_counter() - t0:.1f} s")
    if "train" in phases:
        t0 = time.perf_counter()
        launches["train"] = phase_train(dev)
        log(f"phase train: {time.perf_counter() - t0:.1f} s")
    if "train_peers" in phases:
        t0 = time.perf_counter()
        launches["train_peers"] = phase_train_peers(dev)
        log(f"phase train_peers: {time.perf_counter() - t0:.1f} s")
    if "sweep" in phases:
        t0 = time.perf_counter()
        launches["sweep"] = phase_sweep(dev)
        torch.cuda.empty_cache()
        log(f"phase sweep: {time.perf_counter() - t0:.1f} s")
    if "async" in phases:
        t0 = time.perf_counter()
        launches["async"] = phase_async(dev)
        torch.cuda.empty_cache()
        log(f"phase async: {time.perf_counter() - t0:.1f} s")
    if "train_parity" in phases:
        t0 = time.perf_counter()
        phase_train_parity(dev)
        log(f"phase train_parity: {time.perf_counter() - t0:.1f} s")
    if "spec" in phases:
        t0 = time.perf_counter()
        launches["spec"] = phase_spec(dev)
        torch.cuda.empty_cache()
        log(f"phase spec: {time.perf_counter() - t0:.1f} s")
    if "fleet_codist" in phases:
        t0 = time.perf_counter()
        launches["fleet_codist"] = phase_fleet_codist(dev)
        torch.cuda.empty_cache()
        log(f"phase fleet_codist: {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (src, tpu) in SOURCES.items():
        row = kernel_rows.get(name, {})
        by_path = {p: launches[p].get(name, 0) for p in PATHS[name]
                   if p in launches}
        for p, n in by_path.items():
            require(n > 0, f"{name}: a kernel of the {p} path was never "
                    "launched there")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": row.get("max_abs_err"),
            "ms": row.get("ms"), "kernel_ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms"),
            **{k: v for k, v in row.items()
               if k.startswith(("verify_", "canary_"))}})
    log(f"total: {time.perf_counter() - t_start:.1f} s; launch counts "
        f"{dict(_build.launch_counts)}")
    log(smi_line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
