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
``--hedge``, ``--recover-after-ms`` and ``--degraded-admission``. The
legacy single-engine path, ``--single``, runs one ``Engine.generate`` batch
of ``--batch`` random prompts of ``--prompt-len`` tokens and ``--max-new``
new ones (no fleet); it also serves the enc-dec archs (transformer-big and
whisper-tiny, whose reduced configs read seeded encoder frames) and the VLM
internvl2 (seeded patch embeddings before the prompt), which the fleet
refuses, as the reference's launcher does. ``--trace``, ``--metrics`` and ``--alerts``
write the reference's observability files on the fleet's simulated clock,
``--rules`` a rules file and ``--flight-recorder`` a postmortem directory
(both need ``--alerts``); with ``--single`` these flags exit with status 2,
as in the reference.
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
from repro_torch.serve import Engine, resolve_cache_dtype
from repro_torch.serve.fleet import (POLICIES, SCENARIOS, ChaosConfig,
                                     FleetConfig, FleetDefense, FleetRouter,
                                     SpecConfig, generate_workload)

from repro_torch.obs import (FlightRecorder, MetricsRegistry, Watchtower,
                             default_rules, for_sim_ms, load_rules)


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
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto trace of the run here "
                         "(simulated-ms clock; byte-identical per seed)")
    ap.add_argument("--metrics", default="",
                    help="write the metrics registry as JSON here")
    ap.add_argument("--alerts", default="",
                    help="evaluate Watchtower alert rules on the decode-tick "
                         "clock and write the alert JSONL here")
    ap.add_argument("--rules", default="",
                    help="JSON alert-rules file for --alerts (default: the "
                         "built-in pack, SLO from --slo-ms)")
    ap.add_argument("--flight-recorder", default="",
                    help="dump postmortem bundles into this directory on "
                         "every fired alert or injected fault (needs "
                         "--alerts)")
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
    if args.single and (args.trace or args.metrics or args.alerts
                        or args.flight_recorder):
        ap.error("--trace/--metrics/--alerts/--flight-recorder "
                 "instrument the fleet's simulated clock: fleet mode "
                 "only (drop --single)")
    if not args.single:
        if args.rules and not args.alerts:
            ap.error("--rules requires --alerts")
        if args.flight_recorder and not args.alerts:
            ap.error("--flight-recorder requires --alerts (bundles dump on "
                     "fired alerts and injected faults)")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if not hasattr(cfg, "is_encdec") or (
            (cfg.is_encdec or cfg.num_patches) and not args.single):
        # a classifier is not served (the reference's launcher dies on
        # one); the fleet's workload drives text prompts only, so enc-dec
        # and VLM archs take --single, as the reference's launcher sends
        # them
        print(f"--arch {args.arch}: this CLI serves decoder LMs in fleet "
              "mode (an enc-dec or VLM arch through --single), and a "
              "classifier is not served", file=sys.stderr)
        sys.exit(2)
    device = resolve_device(args.device)
    model = build_model(cfg)
    cache_dtype = resolve_cache_dtype(args.cache_dtype, device)
    if args.single:
        return _single(args, cfg, model, cache_dtype, device)

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
    # the flight recorder rides the tracer's events, so it implies an
    # internal tracer; alerting implies an internal registry (neither is
    # written unless asked for)
    tracer = (for_sim_ms() if args.trace or args.flight_recorder else None)
    metrics = (MetricsRegistry() if args.metrics or args.alerts else None)
    watch = recorder = None
    if args.alerts:
        rules = (load_rules(args.rules) if args.rules
                 else default_rules(slo_ms=args.slo_ms))
        watch = Watchtower(metrics, rules, unit_us=1000.0, clock="sim_ms")
        if args.flight_recorder:
            recorder = FlightRecorder(args.flight_recorder, metrics=metrics)
            tracer.recorder = recorder
            watch.on_alert(recorder.on_alert)
            watch.on_fault(recorder.on_fault)
    router = FleetRouter(model, peer_params, config=fc, policy=args.router,
                         cache_dtype=cache_dtype,
                         canary_every=args.canary_every,
                         snapshot_dir=args.snapshot_dir or None,
                         refresh_every_ms=args.refresh_every_ms,
                         staleness_bound=args.staleness_bound,
                         chaos=chaos, defense=defense, tracer=tracer,
                         metrics=metrics, watch=watch, spec=spec,
                         device=device)
    if recorder is not None:
        # postmortems carry the offending ids: each peer's live requests and
        # queue at dump time (simulated-clock state only)
        recorder.context_fn = lambda: {
            "peers": [
                {"peer": i, "dead": e.dead,
                 "now_ms": round(e.now_ms, 6),
                 "live_rids": sorted(sl.record.request.rid
                                     for sl in e.slots.values()),
                 "queued": len(e.waiting)}
                for i, e in enumerate(router.engines)]}
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
    if tracer is not None and args.trace:
        tracer.save(args.trace)
        print(f"wrote {args.trace} ({tracer.n_events} trace events)")
    if metrics is not None and args.metrics:
        metrics.save(args.metrics)
        print(f"wrote {args.metrics}")
    if watch is not None:
        watch.save(args.alerts)
        s = watch.summary()
        print(f"wrote {args.alerts} ({s['n_events']} alert events; "
              f"still firing: {', '.join(s['firing']) or 'none'})")
    if recorder is not None:
        print(f"flight recorder: {len(recorder.dumped)} postmortem "
              f"bundle(s) in {args.flight_recorder}")


def _single(args, cfg, model, cache_dtype, device) -> None:
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen, device=device, weight_dtype=cfg.activation_dtype)
    engine = Engine(model, params, cache_dtype=cache_dtype, device=device)
    gen.manual_seed(args.seed + 1)
    batch = {"tokens": torch.randint(0, cfg.padded_vocab,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=device)}
    if cfg.num_patches:
        batch["patches"] = 0.1 * torch.randn(
            (args.batch, cfg.num_patches, cfg.d_model), generator=gen,
            device=device)
    if cfg.is_encdec:
        batch["frames"] = 0.1 * torch.randn(
            (args.batch, cfg.num_audio_frames, cfg.d_model), generator=gen,
            device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    result = engine.generate(batch, args.max_new, args.temperature, args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = args.batch * args.max_new
    print(f"arch={args.arch} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.max_new}")
    print(f"generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, {dt / args.max_new * 1e3:.1f} ms/step)")
    print("first sequence:", result.tokens[0, args.prompt_len:].tolist())


if __name__ == "__main__":
    main()
