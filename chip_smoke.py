#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Drives the port's serving path (``src/repro_torch``) on the card and checks
it, phase by phase; any failure raises and the script exits non-zero:

  1. device   — a CUDA card or exit 1; print its nvidia-smi name and power
                limit; TF32 off for the parity phases.
  2. build    — compile the CUDA kernels (one nvcc per source, together).
  3. kernels  — each kernel against its plain PyTorch version at the main
                path's shapes (qwen2-7b: S=16 slots, H=28, KVh=4, hd=128,
                BS=16, MB=34, NB=1025; ragged lengths incl. 0, dead table
                entries aimed at a NaN-poisoned free block), in bf16 and
                fp32; kernel, plain and library-call times with CUDA events.
  4. fleet    — qwen2-7b at full width and depth (28 layers, bf16 weights
                and pools, seeded random weights), 2 peers, 24 bursty
                requests through ``FleetRouter.run`` on the fused path,
                with launch counts checked against the decode ticks; then
                one decode tick through the gather path (``--fused-attention
                off``) on the same weights and pool, against the fused tick.
  5. parity   — reduced qwen2-7b in fp32: the port on the card and on the
                CPU (plain versions) with the same weights and workload;
                teacher-forced logits within 1e-4, equal ``FleetReport``s.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of the JAX reference.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "fleet", "parity")

# main-path shapes (qwen2-7b fleet: FleetConfig(max_slots=16, block_size=16,
# num_blocks=1025, max_blocks_per_slot=34))
S, H, KVH, HD, BS, MB, NB = 16, 28, 4, 128, 16, 34, 1025
LENGTHS = [0, 1, 15, 16, 17, 31, 47, 100, 255, 256, 300, 401, 511, 512, 530,
           543]
POISON = 1           # a free block filled with NaN, named only by dead entries

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 and bf16 FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

SOURCES = {
    "paged_scatter": ("src/repro_torch/csrc/paged_cache.cu",
                      "src/repro/kernels/paged_cache.py:114"),
    "paged_gather": ("src/repro_torch/csrc/paged_cache.cu",
                     "src/repro/kernels/paged_cache.py:60"),
    "paged_attention_decode": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:101"),
}


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


def time_ms(fn, flush: torch.Tensor, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` from CUDA events around each call, with
    the L2 cache flushed before every call (decode finds the pools cold:
    the layer's weights pass through L2 between two attention calls). A
    call that synchronises with the host inside (the plain decode) still
    counts the host time after its sync."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
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


def phase_kernels(dev: torch.device, flush: torch.Tensor):
    from repro_torch.kernels import (paged_attention_decode,
                                     paged_attention_decode_plain,
                                     paged_gather, paged_gather_plain,
                                     paged_scatter, paged_scatter_plain)
    inp = kernel_inputs()
    t = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}
    lengths, table = t["lengths"], t["table"]
    n_live = ((lengths + BS) // BS).to(torch.int32)
    writers = int((t["wslot"] >= 0).sum())
    rows = int((lengths.long() + 1).sum())
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        es = torch.tensor([], dtype=dtype).element_size()
        k, v, q, new = (t[x].to(dtype) for x in ("k", "v", "q", "new"))

        # scatter: bit-exact, null block stays 0, poisoned block untouched
        kk, kp = k.clone(), k.clone()
        paged_scatter(kk, new, t["wslot"], t["woff"])
        paged_scatter_plain(kp, new, t["wslot"], t["woff"])
        sync(dev)
        require(bits_equal(kk, kp), f"paged_scatter {name}: kernel != plain")
        require(not bool((kk[0] != 0).any()),
                f"paged_scatter {name}: null block written")
        require(bits_equal(kk[POISON], k[POISON]),
                f"paged_scatter {name}: poisoned block written")
        vv = v.clone()
        paged_scatter(vv, new, t["wslot"], t["woff"])

        # gather: bit-exact (zeros past n_live, poison never read)
        g_k = paged_gather(kk, table, n_live)
        g_p = paged_gather_plain(kk, table, n_live)
        sync(dev)
        require(bits_equal(g_k, g_p), f"paged_gather {name}: kernel != plain")
        require(not torch.isnan(g_k).any(), f"paged_gather {name}: read poison")

        # decode attention: fp32 state in both; tolerance below
        o_k = paged_attention_decode(q, kk, vv, table, lengths)
        o_p = paged_attention_decode_plain(q, kk, vv, table, lengths)
        sync(dev)
        require(bool(torch.isfinite(o_k).all()), f"decode {name}: non-finite")
        require(not bool((o_k[0] != 0).any()),
                f"decode {name}: inactive slot output != 0")
        err = float((o_k.float() - o_p.float()).abs().max())
        # fp32: the two sum the hd-long dots and BS-long p@v in other orders
        # (~1e-7 relative); bf16: both round the same fp32 value at the end,
        # so they differ by at most one bf16 ulp at the output's scale
        tol = 1e-5 if dtype == torch.float32 else bf16_ulp(o_p)
        log(f"kernels {name}: scatter/gather bit-exact; decode max|kernel-plain|"
            f" = {err:.3e} (tol {tol:.3e})")
        require(err <= tol, f"decode {name}: max abs err {err} > {tol}")
        if dtype != torch.bfloat16:
            continue

        # ---- times at the main-path dtype (bf16) ----
        blk_ix = torch.nonzero(t["wslot"] >= 0).flatten()
        off_ix = t["woff"][blk_ix].long()
        src_rows = new[t["wslot"][blk_ix].long()]
        flat_table = table.reshape(-1).long()
        kx = g_k.view(S, MB * BS, KVH, HD).permute(0, 2, 1, 3)   # S,KVh,T,hd
        vx = paged_gather(vv, table, n_live).view(S, MB * BS, KVH, HD).permute(0, 2, 1, 3)
        kx = kx.repeat_interleave(H // KVH, dim=1).contiguous()
        vx = vx.repeat_interleave(H // KVH, dim=1).contiguous()
        mask = (torch.arange(MB * BS, device=dev)[None, :]
                <= lengths[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row_b = KVH * HD * es
        block_b = BS * row_b
        live_blocks = int(n_live.sum())
        flops_decode = 4 * H * HD * rows
        bytes_decode = (2 * rows * row_b + 2 * q.numel() * es
                        + table.numel() * 4 + lengths.numel() * 4)
        bytes_scatter = 2 * writers * row_b + 2 * NB * 4
        bytes_gather = (live_blocks * block_b + S * MB * block_b
                        + table.numel() * 4 + S * 4)

        def bound(nbytes, flops):
            tb, tf = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
            return max(tb, tf), ("bytes" if tb >= tf else "operations")

        specs = {
            "paged_scatter": (
                lambda: paged_scatter(kk, new, t["wslot"], t["woff"]),
                lambda: paged_scatter_plain(kp, new, t["wslot"], t["woff"]),
                lambda: kp.index_put_((blk_ix, off_ix), src_rows),
                bound(bytes_scatter, 0), 0.0),
            "paged_gather": (
                lambda: paged_gather(kk, table, n_live),
                lambda: paged_gather_plain(kk, table, n_live),
                lambda: kk.index_select(0, flat_table),
                bound(bytes_gather, 0), 0.0),
            "paged_attention_decode": (
                lambda: paged_attention_decode(q, kk, vv, table, lengths),
                lambda: paged_attention_decode_plain(q, kk, vv, table, lengths),
                lambda: sdpa(q4, kx, vx, attn_mask=mask),
                bound(bytes_decode, flops_decode), err),
        }
        for kname, (kern, plain, lib, (b_ms, b_by), kerr) in specs.items():
            results[kname] = {
                "ms": time_ms(kern, flush), "plain_ms": time_ms(plain, flush),
                "library_ms": time_ms(lib, flush), "bound_ms": b_ms,
                "bound_by": b_by, "max_abs_err": kerr}
            r = results[kname]
            log(f"  {kname} bf16: kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  "
                f"bound {r['bound_ms']:.5f} ms ({b_by})")
    return results


# ----------------------------------------------------------------------------
# phase 4: full-width fleet
# ----------------------------------------------------------------------------

def phase_fleet(dev: torch.device, cfg):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serve.fleet import (FleetConfig, FleetEngine, FleetRouter,
                                         Request, generate_workload)
    from repro_torch.serve.fleet.model_exec import build_decode_step
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
    router = FleetRouter(model, peers, config=fc, policy="round_robin",
                         cache_dtype=torch.bfloat16, device=dev)
    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    rep = router.run(wl, slo_ms=50.0)
    sync(dev)
    wall = time.perf_counter() - t0
    fused_counts = dict(launch_counts)
    ticks = [e.decode_ticks for e in router.engines]
    n_layers = cfg.num_layers
    log(f"fleet run: completed {rep.completed}/{len(wl.requests)}, "
        f"{rep.generated_tokens} tokens, decode ticks per peer {ticks}, "
        f"launches {fused_counts}, {wall:.2f} s wall, "
        f"{rep.generated_tokens / wall:.1f} tokens/s wall (prefill included)")
    require(rep.completed == len(wl.requests) and rep.rejected == 0,
            f"fleet: {rep.completed} completed, {rep.rejected} rejected")
    require(rep.lost_tokens == 0 and rep.duplicated_tokens == 0,
            "fleet: a stream is short or long of max_new")
    require(fused_counts["paged_attention_decode"] == n_layers * sum(ticks),
            f"decode launches {fused_counts['paged_attention_decode']} != "
            f"{n_layers} x {sum(ticks)} ticks")
    require(fused_counts["paged_scatter"] == 2 * n_layers * sum(ticks),
            f"scatter launches {fused_counts['paged_scatter']} != "
            f"{2 * n_layers} x {sum(ticks)} ticks")
    require(fused_counts["paged_gather"] == 0, "fused path launched gather")
    toks = [t for r in router._primaries for t in r.tokens]
    require(all(0 <= t < cfg.padded_vocab for t in toks),
            "fleet: token id out of range")
    require(len(toks) == rep.generated_tokens, "fleet: token count mismatch")

    # one engine with 16 live slots: fused tick vs gather tick, same state
    eng = FleetEngine(model, peers[0], replace(fc, max_prefills_per_step=S),
                      cache_dtype=torch.bfloat16, device=dev)
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
    require(oracle_counts["paged_gather"] == 2 * n_layers
            and oracle_counts["paged_attention_decode"] == 0,
            f"gather tick launches {oracle_counts}")
    scale = float(fused.abs().max())
    diff = float((fused - oracle).abs().max())
    agree = int((fused.argmax(-1) == oracle.argmax(-1)).sum())
    # bf16 activations round differently on the two attention paths (fp32
    # kernel state vs bf16 scores/weights of the oracle), and the difference
    # compounds over 28 layers: allow 5% of the logits' max magnitude
    log(f"fused vs gather tick: max|dlogits| = {diff:.4f} "
        f"(max|logits| {scale:.3f}, tol {0.05 * scale:.4f}), argmax agree "
        f"{agree}/{S}, gather launches {oracle_counts}")
    require(bool(torch.isfinite(fused).all() and torch.isfinite(oracle).all()),
            "non-finite decode logits")
    require(diff <= 0.05 * scale, f"fused vs gather logits differ by {diff}")

    sync(dev)
    t0 = time.perf_counter()
    n_ticks = 5
    for _ in range(n_ticks):
        eng.decode_logits(active, tokens)
    sync(dev)
    tick_ms = (time.perf_counter() - t0) / n_ticks * 1e3
    ctx = [int(x) for x in eng.pool.lengths]
    log(f"decode tick (16 live slots, contexts {min(ctx)}..{max(ctx)}): "
        f"{tick_ms:.2f} ms wall/tick = {S / tick_ms * 1e3:.1f} tokens/s")
    if dev.type == "cuda":
        profile_ticks(eng, active, tokens, tick_ms)
    return {"paged_scatter": fused_counts["paged_scatter"],
            "paged_attention_decode": fused_counts["paged_attention_decode"],
            "paged_gather": oracle_counts["paged_gather"]}


def profile_ticks(eng, active, tokens, tick_ms: float, n: int = 3) -> None:
    """Device time of ``n`` decode ticks by kernel (torch.profiler) against
    their wall time: the device's busy share of a tick."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(n):
            eng.decode_logits(active, tokens)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue         # CPU ops also report their kernels' time
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / n
    if not rows:
        log("profile: the profiler reported no device time (not measured)")
        return
    log(f"profile: device busy {busy_ms:.2f} ms of {tick_ms:.2f} ms wall per "
        f"tick ({busy_ms / tick_ms:.1%}); top kernels by device time per tick:")
    for us, count, key in rows[:8]:
        log(f"  {us / 1e3 / n:8.3f} ms  {count // n:5d} calls  {key[:90]}")


# ----------------------------------------------------------------------------
# phase 5: fp32 card vs CPU
# ----------------------------------------------------------------------------

def phase_parity(dev: torch.device):
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
    reps = {d: FleetRouter(model, params[d], config=fc, policy="least_loaded",
                           device=devices[d]).run(wl).to_dict()
            for d in devices}
    bad = {k: (reps["cpu"][k], reps["card"][k]) for k in reps["cpu"]
           if reps["cpu"][k] != reps["card"][k]}
    log(f"parity: FleetReport card vs CPU: {len(reps['cpu']) - len(bad)}/"
        f"{len(reps['cpu'])} fields equal, digest {reps['card']['stream_digest'][:16]}")
    require(not bad, f"FleetReport fields differ card vs CPU: {bad}")

    # teacher-forced: the same 8 prompts admitted on both devices, 4 ticks
    # fed the CPU's argmax tokens on both
    logits, engines = {}, {}
    fc8 = replace(fc, max_slots=8, max_prefills_per_step=8)
    for d in devices:
        eng = FleetEngine(model, params[d][0], fc8, keep_logits=True,
                          device=devices[d])
        for r in wl.requests:
            eng.enqueue(Request(r.rid, 0.0, r.prompt, 8))
        eng._intake()
        eng._admit()
        logits[d] = [torch.from_numpy(np.stack(
            [eng.slots[s].record.prefill_logits for s in range(8)]))]
        engines[d] = eng
    active = np.ones((8,), bool)
    tokens = np.asarray([[engines["cpu"].slots[s].next_token]
                         for s in range(8)], np.int32)
    for _ in range(4):
        for d, eng in engines.items():
            logits[d].append(eng.decode_logits(active, tokens).float().cpu())
            eng.pool.lengths[:] += 1
        tokens = logits["cpu"][-1].argmax(-1, keepdim=True).numpy().astype(np.int32)
    err = max(float((a - b).abs().max()) for a, b in zip(logits["cpu"],
                                                          logits["card"]))
    log(f"parity: teacher-forced fp32 logits (prefill + 4 ticks) max|card-cpu|"
        f" = {err:.3e} (tol 1e-4)")
    require(err <= 1e-4, f"card vs CPU logits differ by {err}")


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
        kernel_rows = phase_kernels(dev, flush)
        del flush
        log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    launches = {}
    if "fleet" in phases:
        t0 = time.perf_counter()
        launches = phase_fleet(dev, get_config("qwen2-7b"))
        torch.cuda.empty_cache()
        log(f"phase fleet: {time.perf_counter() - t0:.1f} s")
    if "parity" in phases:
        t0 = time.perf_counter()
        phase_parity(dev)
        log(f"phase parity: {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (src, tpu) in SOURCES.items():
        row = kernel_rows.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches.get(name, 0),
            "max_abs_err": row.get("max_abs_err"),
            "ms": row.get("ms"), "kernel_ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms")})
    require(all(k["launches"] > 0 for k in kernels) or "fleet" not in phases,
            "a kernel of the main path was never launched")
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
