"""Dry run: the cost model of every (arch x shape x mesh) on H100s.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \
        --shape train_4k --mesh multi --mode codist

The reference lowers and compiles each combination with XLA over 512
forced host devices and reads the compiled module's memory, FLOPs and
collectives. The port's counterpart builds the same inputs and state as
shape stand-ins on ``torch.device("meta")`` (``launch/specs.py``), places
them with the reference's rules (``launch/sharding.py``) on the production
mesh (256 or 512 H100s, ``launch/mesh.py``), and counts one step's
per-device FLOPs, bytes and collectives with ``launch/cost.py``; the
roofline terms use the H100's peaks (``launch/roofline.py``). It describes
a deployment of 256-512 GPUs; nothing is allocated on any device, so it
runs anywhere, card or not. A placement rule that does not cover a leaf,
or a spec that does not divide its shape, fails here.

Each record has the reference's keys: ``arch, shape, mesh, mode, variant,
codist_extra, chips, memory`` (per device: ``argument_bytes``, the params,
optimizer moments and gradients as placed; ``temp_bytes``, the activation
estimate), ``cost``, ``collectives`` (counts, bytes by kind, total, cross-
and intra-pod bytes), ``roofline`` and ``status``. ``main`` resumes from
its output file as the reference's does.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import replace
from typing import Dict, Optional

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config)
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs as sp
from repro_torch.launch.cost import step_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import build_report
from repro_torch.models import build_model

# dense-family archs take the sliding-window variant for long_500k (the
# sub-quadratic carve-in); whisper skips it entirely
SLIDING_WINDOW_FOR_LONG = 8192
SKIP = {("whisper-tiny", "long_500k")}


def dryrun_config(arch: str):
    """The full config in dry-run numerics: bf16 params and activations."""
    return replace(get_config(arch), dtype="bfloat16",
                   param_dtype="bfloat16")


def adapt_for_shape(cfg, shape_name: str):
    if shape_name == "long_500k" and not cfg.attention_free \
            and cfg.attn_layer_period == 0:
        # dense / moe / vlm: sliding-window attention => O(W) decode state
        cfg = replace(cfg, sliding_window=SLIDING_WINDOW_FOR_LONG)
    return cfg


def pick_microbatch(cfg, shape, data_ways: int, n_models: int = 1,
                    target_gb: float = 2.5) -> int:
    """Gradient-accumulation factor: keep the per-device activations saved
    for backward (one (B, S, d) bf16 residual a layer) under ``target_gb``;
    k keeps B/n/k divisible by the data axis."""
    if getattr(cfg, "kind", None):  # conv models: small
        return 1
    if shape.kind != "train":       # one-token decode / forward-only prefill
        return 1
    b = shape.global_batch // max(1, n_models)
    per_dev = b / data_ways
    carry_gb = per_dev * shape.seq_len * cfg.d_model * 2 * cfg.num_layers / 1e9
    k, max_k = 1, max(1, b // data_ways)
    while carry_gb / k > target_gb and k < max_k:
        k *= 2
    return min(k, max_k)


def _placements(model, cfg, shape, mesh, mode: str, codist_n: int, k: int,
                variant: Dict) -> int:
    """Build the step's stand-ins and place every leaf by the reference's
    rules (as its lowering does); returns the number of leaves placed. A
    spec that does not divide its leaf raises."""
    if shape.kind == "train":
        stacked = mode == "codist"
        state = sp.train_state_specs(model, codist_n if stacked else 0,
                                     "sgdm", cfg.activation_dtype)
        batch = sp.train_batch_specs(cfg, shape,
                                     n_stack=codist_n if stacked else 0,
                                     microbatch=k)
        trees = [(state, sh.state_shardings(
                     state, mesh, stacked=stacked,
                     fsdp_axis=variant.get("train_fsdp_axis", "data"),
                     moe_expert_axis=variant.get("moe_expert_axis"))),
                 (batch, sh.batch_shardings(batch, mesh, stacked=stacked,
                                            microbatched=k > 1))]
    elif shape.kind == "prefill":
        params = sp.params_specs(model)
        batch = sp.prefill_batch_specs(cfg, shape)
        trees = [(params, sh.state_shardings(params, mesh)),
                 (batch, sh.batch_shardings(batch, mesh))]
    else:
        ds = variant.get("decode_sharding", "fsdp")
        params = sp.params_specs(model)
        cache = sp.cache_specs(model, cfg, shape)
        tok = {"tokens": sp.decode_token_specs(shape)}
        trees = [(params, sh.state_shardings(
                     params, mesh, fsdp_axis=None if ds == "ws" else "data",
                     moe_expert_axis=variant.get("moe_expert_axis"),
                     two_d_ffn=ds == "2d")),
                 (cache, sh.cache_shardings(cache, mesh, shape.global_batch,
                                            prefer_time=ds == "repl-batch")),
                 (tok, sh.batch_shardings(tok, mesh))]
    n = 0
    for tree, specs in trees:
        flat = dict(sh.tree_flatten_with_path(specs))
        for path, leaf in sh.tree_flatten_with_path(tree):
            sh.local_shape(tuple(leaf.shape), flat[path], mesh)
            n += 1
    return n


def run_one(arch: str, shape_name: str, multi_pod: bool, mode: str = "auto",
            codist_n: int = 2, remat: bool = True, verbose: bool = True,
            codist_extra: Optional[Dict] = None,
            variant: Optional[Dict] = None) -> Dict:
    """Place and count one combination; returns the result record."""
    shape = INPUT_SHAPES[shape_name]
    cfg = adapt_for_shape(dryrun_config(arch), shape_name)
    model = build_model(cfg)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = mesh.size
    variant = dict(variant or {})
    if mode == "auto":
        # the paper's deployment: codistillation across pods for training,
        # plain serving (one model) for the inference shapes
        mode = "codist" if (shape.kind == "train" and multi_pod) else (
            "allreduce" if shape.kind == "train" else shape.kind)
    sizes = mesh.shape
    k = 1
    if shape.kind == "train":
        k = (pick_microbatch(cfg, shape, sizes["data"], codist_n)
             if mode == "codist" else
             pick_microbatch(cfg, shape, sizes["data"] * sizes.get("pod", 1)))

    t0 = time.time()
    leaves = _placements(model, cfg, shape, mesh, mode, codist_n, k, variant)
    cost = step_cost(cfg, shape, mode, codist_n, remat, k, mesh, variant,
                     codist_extra)
    t_count = time.time() - t0
    coll = cost.collectives
    report = build_report(arch, shape, mesh_name, chips, cost.flops,
                          cost.bytes, coll.intra_node_bytes,
                          coll.inter_node_bytes, coll.cross_pod_bytes, cfg,
                          note=mode)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "mode": mode,
        "variant": variant, "codist_extra": codist_extra or {},
        "chips": chips, "count_s": round(t_count, 2), "microbatch": k,
        "leaves_placed": leaves,
        "cost": {"flops": cost.flops, "bytes accessed": cost.bytes,
                 "gemm_flops": cost.gemm_flops,
                 "kernel_flops": cost.kernel_flops,
                 "other_flops": cost.other_flops,
                 "gemm_bytes": cost.gemm_bytes,
                 "kernel_bytes": cost.kernel_bytes,
                 "other_bytes": cost.other_bytes},
        "memory": {"argument_bytes": cost.argument_bytes,
                   "temp_bytes": cost.temp_bytes},
        "collectives": {"counts": coll.counts(),
                        "bytes_by_kind": coll.by_kind(),
                        "total_bytes": coll.total_bytes,
                        "cross_pod_bytes": coll.cross_pod_bytes,
                        "intra_pod_bytes": coll.intra_pod_bytes,
                        "inter_node_bytes": coll.inter_node_bytes},
        "roofline": report.to_dict(),
        "status": "ok",
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ({mode}): "
              f"flops/dev {cost.flops:.3e}, bytes/dev {cost.bytes:.3e}, "
              f"coll {coll.total_bytes / 1e6:.1f}MB (cross-pod "
              f"{coll.cross_pod_bytes / 1e6:.1f}MB), "
              f"bottleneck={report.bottleneck}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "allreduce", "codist"])
    ap.add_argument("--codist-n", type=int, default=2)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--decode-sharding", default="fsdp",
                    choices=["fsdp", "ws", "2d", "repl-batch"])
    ap.add_argument("--moe-experts", default="",
                    help="mesh axis to shard MoE experts over (e.g. data)")
    ap.add_argument("--no-train-fsdp", action="store_true",
                    help="TP-only sharding for non-expert train params")
    ap.add_argument("--compression", default="",
                    choices=["", "none", "topk", "bf16", "subsample"])
    ap.add_argument("--topk", type=int, default=64)
    ap.add_argument("--subsample", type=int, default=0)
    ap.add_argument("--tag", default="", help="suffix for the output file")
    ap.add_argument("--all", action="store_true",
                    help="all archs x shapes for the chosen mesh")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--fresh", action="store_true",
                    help="count every combination again instead of resuming "
                         "from the records already in the output file")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    combos = []
    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    for a in archs:
        for s in shapes:
            if (a, s) in SKIP:
                print(f"[dryrun] SKIP {a} x {s}", flush=True)
                continue
            combos.append((a, s))
    if not args.all and args.arch is None:
        combos = combos[:1]

    multi = args.mesh == "multi"
    variant = {}
    if args.decode_sharding != "fsdp":
        variant["decode_sharding"] = args.decode_sharding
    if args.moe_experts:
        variant["moe_expert_axis"] = args.moe_experts
    if args.no_train_fsdp:
        variant["train_fsdp_axis"] = None
    codist_extra = {}
    if args.compression and args.compression != "none":
        codist_extra["compression"] = args.compression
        if args.compression == "topk":
            codist_extra["topk"] = args.topk
        if args.compression == "subsample":
            codist_extra["subsample"] = args.subsample
    results = []
    suffix = f"_{args.tag}" if args.tag else ""
    out_path = os.path.join(args.out,
                            f"dryrun_{args.mesh}_{args.mode}{suffix}.json")
    # resume: skip the combos already recorded as ok
    done = set()
    if os.path.exists(out_path) and not args.fresh:
        with open(out_path) as f:
            results = json.load(f)
        done = {(r["arch"], r["shape"]) for r in results
                if r.get("status") == "ok"}
    n_cached = 0
    for a, s in combos:
        if (a, s) in done:
            print(f"[dryrun] cached {a} x {s}", flush=True)
            n_cached += 1
            continue
        try:
            rec = run_one(a, s, multi, args.mode, args.codist_n,
                          remat=not args.no_remat,
                          codist_extra=codist_extra or None,
                          variant=variant or None)
        except Exception as e:
            rec = {"arch": a, "shape": s, "mesh": args.mesh,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[dryrun] FAIL {a} x {s}: {e}", flush=True)
        results = [r for r in results
                   if not (r["arch"] == a and r["shape"] == s)]
        results.append(rec)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1, default=str)
    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"[dryrun] {ok}/{len(results)} ok ({len(combos) - n_cached} "
          f"counted by this run, {n_cached} read from the file) -> "
          f"{out_path}", flush=True)


if __name__ == "__main__":
    main()
