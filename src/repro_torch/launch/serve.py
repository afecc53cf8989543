"""Serving launcher: the continuous-batching fleet, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --peers 2 --scenario bursty --requests 32 --router least_loaded

The flags are the reference launcher's, plus ``--device`` (``cuda`` by
default; ``cpu`` runs the kernels' plain versions). As in the reference,
``--reduced`` is a ``store_true`` flag that defaults to on, so the CLI
serves the reduced config; ``chip_smoke.py`` drives the full-size config
through ``FleetRouter`` directly.

``--speculative`` (or ``--router speculative``) serves by peer-speculative
decoding with ``--draft-k`` drafts a round, ring-paired or from the
``--draft-peer``; ``--router ensemble`` and ``--canary-every N`` compare
peers' prefill logits; ``--snapshot-dir`` refreshes peer weights from
``checkpoint/io.py`` snapshots (the async runtime's ``runtime_ckpt/``);
``--faults`` takes the training CLI's fault spec on the decode-tick clock
(pauses in simulated ms), defended unless ``--no-defend``, with
``--hedge``, ``--recover-after-ms`` and ``--degraded-admission``. Flags of
features the port has not reached (``--single``, the observability flags)
exit with status 2 and name the item that brings them.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.kernels.paged_cache import is_quantized_dtype
from repro_torch.models import build_model
from repro_torch.runtime.clock import parse_faults
from repro_torch.serve import resolve_cache_dtype
from repro_torch.serve.fleet import (POLICIES, SCENARIOS, ChaosConfig,
                                     FleetConfig, FleetDefense, FleetRouter,
                                     SpecConfig, generate_workload)

_OBS = "tracing, metrics and alerts come with the observability port (ROADMAP Queue 1 item 11)"


def _unported(args) -> list:
    """(flag, reason) for every unported feature the arguments ask for."""
    out = []
    for flag, val in (("--trace", args.trace), ("--metrics", args.metrics),
                      ("--alerts", args.alerts), ("--rules", args.rules),
                      ("--flight-recorder", args.flight_recorder)):
        if val:
            out.append((flag, _OBS))
    if args.single:
        out.append(("--single", "the dense Engine.generate path comes with "
                    "ROADMAP Queue 1 item 6"))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dtype", default="auto",
                    help="KV pool dtype: auto (bf16 on the card, fp32 on the "
                         "CPU), bf16, fp16, fp32, or the quantized int8 / fp8 "
                         "(fleet mode only)")
    ap.add_argument("--fused-attention", default="auto",
                    choices=("auto", "on", "off"),
                    help="decode attention path: the paged-attention kernel "
                         "(auto/on) or the gather + dense-softmax oracle (off)")
    ap.add_argument("--max-new", type=int, default=16)
    # ---- fleet mode ----
    ap.add_argument("--peers", type=int, default=2)
    ap.add_argument("--scenario", default="steady", choices=list(SCENARIOS))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="TTFT SLO (simulated ms)")
    ap.add_argument("--router", default="round_robin", choices=list(POLICIES))
    ap.add_argument("--canary-every", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8, help="decode slots per peer")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=128)
    ap.add_argument("--max-prompt", type=int, default=48)
    ap.add_argument("--snapshot-dir", default="")
    ap.add_argument("--refresh-every-ms", type=float, default=0.0)
    ap.add_argument("--staleness-bound", type=int, default=0)
    # ---- speculative decoding ----
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--draft-k", type=int, default=4)
    ap.add_argument("--draft-peer", default="ring")
    ap.add_argument("--identical-peers", action="store_true",
                    help="init every peer from the SAME seed")
    # ---- chaos ----
    ap.add_argument("--faults", default="none")
    ap.add_argument("--fault-horizon", type=int, default=4096)
    ap.add_argument("--recover-after-ms", type=float, default=0.0)
    ap.add_argument("--no-defend", action="store_true")
    ap.add_argument("--hedge", action="store_true")
    ap.add_argument("--degraded-admission", default="on", choices=("on", "off"))
    ap.add_argument("--report", default="", help="write the JSON report here")
    # ---- observability ----
    ap.add_argument("--trace", default="")
    ap.add_argument("--metrics", default="")
    ap.add_argument("--alerts", default="")
    ap.add_argument("--rules", default="")
    ap.add_argument("--flight-recorder", default="")
    # ---- legacy single-engine mode ----
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    if args.single and is_quantized_dtype(
            resolve_cache_dtype(args.cache_dtype, "cpu")):
        ap.error(f"--cache-dtype {args.cache_dtype} is a quantized "
                 "paged-pool dtype: fleet mode only (drop --single)")
    unported = _unported(args)
    if unported:
        for flag, why in unported:
            print(f"{flag}: not in the port yet — {why}", file=sys.stderr)
        sys.exit(2)
    try:
        cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    except NotImplementedError as e:
        print(f"--arch {args.arch}: {e}", file=sys.stderr)
        sys.exit(2)
    device = resolve_device(args.device)
    model = build_model(cfg)
    cache_dtype = resolve_cache_dtype(args.cache_dtype, device)

    if args.speculative:
        args.router = "speculative"
    spec = None
    if args.router == "speculative":
        if args.draft_peer == "ring":
            draft_peer = None
        else:
            try:
                draft_peer = int(args.draft_peer)
            except ValueError:
                ap.error(f"--draft-peer {args.draft_peer!r}: expected "
                         "'ring' or a peer index")
            if not 0 <= draft_peer < args.peers:
                ap.error(f"--draft-peer {draft_peer} out of range for "
                         f"--peers {args.peers}")
        spec = SpecConfig(k=args.draft_k, draft_peer=draft_peer)

    def peer_init(seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return model.init(gen, device=device, weight_dtype=cfg.activation_dtype)

    if args.identical_peers:
        peer_params = [peer_init(args.seed)] * args.peers
    else:
        peer_params = [peer_init(args.seed + i) for i in range(args.peers)]
    fc = FleetConfig(max_slots=args.slots, block_size=args.block_size,
                     num_blocks=args.num_blocks,
                     max_blocks_per_slot=max(
                         1, -(-(args.max_prompt + args.max_new)
                              // args.block_size)),
                     fused_attention={"auto": None, "on": True,
                                      "off": False}[args.fused_attention])
    chaos = defense = None
    if args.faults and args.faults != "none":
        chaos = ChaosConfig(
            parse_faults(args.faults, args.peers, seed=args.seed),
            horizon_ticks=args.fault_horizon,
            recover_after_ms=args.recover_after_ms)
    if (chaos is not None and not args.no_defend) or args.hedge:
        defense = FleetDefense(
            hedging=args.hedge,
            degraded_admission=(args.degraded_admission == "on"))
    router = FleetRouter(model, peer_params, config=fc, policy=args.router,
                         cache_dtype=cache_dtype,
                         canary_every=args.canary_every,
                         snapshot_dir=args.snapshot_dir or None,
                         refresh_every_ms=args.refresh_every_ms,
                         staleness_bound=args.staleness_bound,
                         chaos=chaos, defense=defense, spec=spec,
                         device=device)
    if args.snapshot_dir:
        n = router.refresh_now()
        print(f"initial weight refresh: {n}/{args.peers} peers from "
              f"{args.snapshot_dir}")
    wl = generate_workload(args.scenario, args.requests, cfg.padded_vocab,
                           seed=args.seed, max_prompt=args.max_prompt,
                           max_new=args.max_new)
    t0 = time.time()
    rep = router.run(wl, slo_ms=args.slo_ms)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    print(f"arch={args.arch} scenario={args.scenario} router={args.router} "
          f"peers={args.peers} requests={args.requests} seed={args.seed} "
          f"device={device}")
    print(f"completed={rep.completed} rejected={rep.rejected} "
          f"generated_tokens={rep.generated_tokens}")
    print(f"TTFT p50/p99 = {rep.p50_ttft_ms:.1f}/{rep.p99_ttft_ms:.1f} ms "
          f"(sim)  e2e p50/p99 = {rep.p50_e2e_ms:.1f}/{rep.p99_e2e_ms:.1f} ms")
    print(f"SLO({rep.slo_ms:.0f}ms TTFT) attainment = "
          f"{rep.slo_attainment:.3f}  sim tok/s = {rep.sim_tokens_per_s:.1f}"
          f"  wall tok/s = {rep.generated_tokens / max(wall, 1e-9):.1f}")
    print(f"pool peak util = {rep.peak_pool_utilization:.2f}  "
          f"kv_bytes = {rep.kv_bytes_written}  refreshes = {rep.refreshes} "
          f"(dropped stale: {rep.refreshes_dropped_stale})")
    if rep.canary.get("count"):
        print(f"canary: n={rep.canary['count']} "
              f"mean_mse={rep.canary['mean_mse']:.4f} "
              f"token_agreement={rep.canary['token_agreement']:.3f}")
    if spec is not None:
        print(f"speculative: k={spec.k} accept_rate="
              f"{rep.spec_accept_rate:.3f} rounds={rep.spec_rounds} "
              f"drafted/accepted = "
              f"{rep.spec_drafted_tokens}/{rep.spec_accepted_tokens}  "
              f"fallback_ticks={rep.spec_fallback_ticks}")
    if chaos is not None or defense is not None:
        print(f"chaos: defended={'no' if defense is None else 'yes'} "
              f"goodput tok/s = {rep.goodput_tokens_per_s:.1f}  "
              f"lost/dup tokens = {rep.lost_tokens}/{rep.duplicated_tokens}")
        print(f"  migrations={rep.migrations} "
              f"(failed: {rep.migration_failures})  hedges={rep.hedges} "
              f"(wins: {rep.hedge_wins})  preemptions={rep.preemptions}  "
              f"died/recovered={rep.peers_died}/{rep.peers_recovered}")
    print(f"lost_tokens={rep.lost_tokens} "
          f"duplicated_tokens={rep.duplicated_tokens}")
    print(f"stream digest = {rep.stream_digest}")
    if args.report:
        with open(args.report, "w") as f:
            f.write(rep.to_json() + "\n")
        print(f"wrote {args.report}")


if __name__ == "__main__":
    main()
