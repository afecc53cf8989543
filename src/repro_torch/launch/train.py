"""Training launcher: codistillation (Algorithm 1) or its all-reduce
baseline, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --mode codist --codist-n 2 --steps 200 --batch 8 --seq 128

The flags are the reference launcher's, plus ``--device`` (``cuda`` by
default; ``cpu`` runs the loss kernels' plain versions). ``--mode`` maps
onto the engine's exchange strategies:

    allreduce         AllReduce            gradient sync baseline
    codist            PredictionExchange   Algorithm 1 logits exchange
    codist-ckpt       CheckpointExchange   Anil et al.'s stale replicas
    codist-pipelined  PipelinedPredictions previous-step targets
    codist-shardmap   ShardMapCompressed   explicit compressed pod exchange:
                                           --codist-n processes (gloo), one
                                           model each, gathering the wire
    codist-async      AsyncPrediction      virtual cluster on independent
                                           step clocks (repro_torch.runtime)
                                           with seeded fault injection:
                                           --faults, --elastic,
                                           --staleness-bound, --join-burn-in,
                                           --checkpoint-every,
                                           --recover-after

``--codist-n`` takes any number of peers and ``--compression`` every wire
(none, bf16, topk, subsample). As in the reference, the CLI has no flag
for the subsample count, so ``--compression subsample`` sends the full
logits, and the async-runtime flags are read only by ``codist-async``.
``--reduced`` is a ``store_true`` flag that defaults to on, so the CLI
trains the reduced config; ``chip_smoke.py`` drives the full-size config
through ``train_codist``, ``train_allreduce`` and ``AsyncScheduler``.
``--mode codist-shardmap`` spawns ``--codist-n`` processes joined by a gloo
group through a ``FileStore`` (``launch/mesh.py``), every one on the same
``--device``, and prints pod 0's History; a group that cannot be made
fails the run. ``--trace``, ``--metrics`` and ``--alerts`` write the
reference's observability files (``codist-async`` on the virtual cluster
clock, the other modes on the step clock); ``--rules`` and
``--flight-recorder`` need ``--alerts``. ``--out DIR`` writes ``DIR/history.json`` (the reference's record
list) and the final parameters as ``DIR/final.npz`` +
``DIR/final.tree.json`` (``checkpoint/io.py``; codistilled peers in the
reference's stacked layout, so its ``load_pytree`` reads them); with
``codist-async`` it writes per-peer ``DIR/peer{pid}.jsonl`` histories and
``DIR/final_peer{pid}`` checkpoints, and ``--checkpoint-every`` keeps the
recovery snapshots under ``DIR/runtime_ckpt``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (params_to_numpy, peer_params_to_numpy,
                                    save_pytree)
from repro_torch.configs import (CodistConfig, TrainConfig, get_config,
                                 get_reduced, list_archs)
from repro_torch.data import MarkovLM, make_lm_batch
from repro_torch.launch.mesh import spawn_pods
from repro_torch.models import build_model
from repro_torch.obs import (FlightRecorder, MetricsRegistry, Watchtower,
                             default_rules, for_sim_seconds, for_steps,
                             load_rules)
from repro_torch.runtime import AsyncScheduler, parse_faults
from repro_torch.train import (History, ShardMapCompressed, stack_batches,
                               train_allreduce, train_codist)
from repro_torch.tree import tree_map

MODES = ["codist", "codist-ckpt", "codist-pipelined", "codist-shardmap",
         "codist-async", "allreduce"]


def _obs(args):
    """The observability hooks the flags ask for, on the run's clock: the
    async runtime's simulated seconds for ``codist-async``, the step clock
    otherwise. The flight recorder rides the tracer's events (an internal
    tracer without ``--trace``); alerting needs a registry (an internal one
    without ``--metrics``). Returns (tracer, metrics, watch, recorder)."""
    is_async = args.mode == "codist-async"
    tracer = metrics = watch = recorder = None
    if args.trace or args.flight_recorder:
        tracer = for_sim_seconds() if is_async else for_steps()
    if args.metrics or args.alerts:
        metrics = MetricsRegistry()
    if args.alerts:
        rules = load_rules(args.rules) if args.rules else default_rules()
        watch = (Watchtower(metrics, rules, unit_us=1_000_000.0, clock="sim_s")
                 if is_async else
                 Watchtower(metrics, rules, unit_us=1000.0, clock="steps"))
    if args.flight_recorder:
        recorder = FlightRecorder(args.flight_recorder, metrics=metrics)
        tracer.recorder = recorder
        watch.on_alert(recorder.on_alert)
        watch.on_fault(recorder.on_fault)
    return tracer, metrics, watch, recorder


def _save_obs(args, tracer, metrics, watch, recorder) -> None:
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--mode", default="codist", choices=MODES)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--codist-n", type=int, default=2)
    ap.add_argument("--period", type=int, default=1)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--alpha-growth", type=float, default=1.0)
    ap.add_argument("--distill-loss", default="mse",
                    choices=["mse", "kl", "ce"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "topk", "bf16", "subsample"])
    ap.add_argument("--topk", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8, help="per-model batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr-schedule", default="cosine",
                    choices=["cosine", "step", "constant"])
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--wd-schedule", action="store_true",
                    help="paper's decayed weight decay")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgdm"])
    ap.add_argument("--fused-losses", default="auto",
                    choices=["auto", "on", "off"],
                    help="fused loss kernels (auto: on for CUDA; 'on' runs "
                         "their plain versions on the CPU)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--faults", default="",
                    help="codist-async fault spec, e.g. "
                         "'straggler=1*4@0.2,preempt=1@3+5,fail=1@30,"
                         "hetero=0.3' (see repro_torch.runtime.parse_faults)")
    ap.add_argument("--elastic", type=float, default=0.0,
                    help="codist-async: a fresh peer joins at this simulated "
                         "time (burn-in before it distills)")
    ap.add_argument("--staleness-bound", type=int, default=-1,
                    help="codist-async: drop peer payloads older than S "
                         "local steps (-1 = keep-last, unbounded)")
    ap.add_argument("--join-burn-in", type=int, default=5,
                    help="codist-async: local steps a joining peer trains "
                         "before its distillation loss activates")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="codist-async: snapshot each peer every N local "
                         "steps (enables failure recovery)")
    ap.add_argument("--recover-after", type=float, default=10.0,
                    help="codist-async: simulated seconds before a failed "
                         "peer rejoins from its snapshot")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default="")
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto trace here (codist-async: "
                         "the virtual cluster clock; other modes: the step "
                         "clock)")
    ap.add_argument("--metrics", default="",
                    help="write the metrics registry as JSON here")
    ap.add_argument("--alerts", default="",
                    help="evaluate Watchtower alert rules on the run's clock "
                         "and write the alert JSONL here")
    ap.add_argument("--rules", default="",
                    help="JSON alert-rules file for --alerts (default: the "
                         "built-in pack)")
    ap.add_argument("--flight-recorder", default="",
                    help="dump postmortem bundles into this directory on "
                         "every fired alert or injected fault (needs "
                         "--alerts)")
    return ap


def model_config(args):
    """The ``--arch`` config: the reduced one (``--reduced`` is always on,
    as in the reference's CLI)."""
    return get_reduced(args.arch) if args.reduced else get_config(args.arch)


def _markov_task(args, cfg) -> MarkovLM:
    vocab = min(cfg.vocab_size, 512)
    return MarkovLM(vocab=vocab, seed=args.seed,
                    effective_vocab=min(vocab, 256))


def _train_config(args) -> TrainConfig:
    return TrainConfig(
        lr=args.lr, lr_schedule=args.lr_schedule, warmup_steps=args.warmup,
        total_steps=args.steps, weight_decay=args.weight_decay,
        weight_decay_schedule=(5e-4, 1e-5, 0.0) if args.wd_schedule else (),
        optimizer=args.optimizer, seed=args.seed,
        fused_losses={"auto": None, "on": True, "off": False}[
            args.fused_losses])


def codist_config(args) -> CodistConfig:
    """The codistillation config the flags ask for."""
    return CodistConfig(
        n_models=args.codist_n,
        mode="checkpoints" if args.mode == "codist-ckpt" else "predictions",
        pipelined=args.mode == "codist-pipelined",
        period=args.period, alpha0=args.alpha,
        alpha_growth=args.alpha_growth, distill_loss=args.distill_loss,
        compression=args.compression, topk=args.topk,
        steps_per_epoch=max(1, args.steps // 10))


def run_training(args, model, device, strategy=None,
                 obs=(None, None, None)):
    """The synchronous modes (all but ``codist-async``) on ``device``:
    ``(state, History, seconds)``. ``strategy`` overrides the one the
    codist config resolves to (a pod's ``ShardMapCompressed``)."""
    task = _markov_task(args, model.cfg)
    tc = _train_config(args)
    tracer, metrics, watch = obs

    def lm_batch(step, seed, group=None):
        return make_lm_batch(task, args.batch, args.seq, step, group,
                             seed=seed, device=device)

    def eval_batches(step):
        if args.mode == "allreduce":
            return lm_batch(10_000 + step, args.seed + 1)
        return stack_batches([lm_batch(10_000 + step, args.seed + 1)
                              for _ in range(args.codist_n)])

    t0 = time.time()
    if args.mode == "allreduce":
        def it():
            s = 0
            while True:
                yield lm_batch(s, args.seed)
                s += 1
        state, hist = train_allreduce(model, tc, it(),
                                      eval_batches=eval_batches,
                                      eval_every=args.eval_every,
                                      log_every=args.log_every, device=device,
                                      tracer=tracer, metrics=metrics,
                                      watch=watch)
    else:
        codist = codist_config(args)
        # coordinated sampling (every peer draws the same batch) except in
        # checkpoint mode, where each peer draws its own
        coordinated = codist.mode == "predictions"

        def batches(step):
            return stack_batches([lm_batch(step, args.seed,
                                           None if coordinated else g)
                                  for g in range(args.codist_n)])

        state, hist = train_codist(model, codist, tc, batches,
                                   eval_batches=eval_batches,
                                   eval_every=args.eval_every,
                                   log_every=args.log_every, device=device,
                                   strategy=strategy, tracer=tracer,
                                   metrics=metrics, watch=watch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return state, hist, time.time() - t0


def shardmap_pod(pods, argv) -> dict:
    """One pod of ``--mode codist-shardmap``, run by ``spawn_pods`` in its
    own process: this pod's model trained through ``ShardMapCompressed``
    on ``pods``, which must compute on the ``--device`` of ``argv``; pod 0
    writes the observability files the flags ask for. Returns its History
    records, wall seconds (the init included) and, with ``--out``, its
    parameters on the CPU."""
    args = build_parser().parse_args(argv)
    want = resolve_device(args.device)
    if (want.type, want.index or 0) != (pods.device.type,
                                        pods.device.index or 0):
        raise ValueError(f"--device {args.device} but the pod group "
                         f"computes on {pods.device}")
    model = build_model(model_config(args))
    obs = _obs(args) if pods.rank == 0 else (None,) * 4
    strategy = ShardMapCompressed(codist_config(args), pods)
    state, hist, dt = run_training(args, model, pods.device, strategy,
                                   obs[:3])
    if pods.rank == 0:
        _save_obs(args, *obs)
    return {"records": hist.records, "seconds": dt,
            "params": (tree_map(lambda p: p.detach().cpu(), state.params)
                       if args.out else None)}


def main(argv=None) -> None:
    ap = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.rules and not args.alerts:
        ap.error("--rules requires --alerts")
    if args.flight_recorder and not args.alerts:
        ap.error("--flight-recorder requires --alerts")
    cfg = model_config(args)
    if not hasattr(cfg, "is_encdec") or cfg.is_encdec:
        # the reference's launcher cannot reach these archs either: its
        # Markov-LM batches are token streams, with no images for a conv
        # net and no encoder frames for an enc-dec arch (whisper-tiny dies
        # there on the missing frames)
        print(f"--arch {args.arch}: this CLI trains decoder LMs on token "
              "batches, which carry no encoder frames or images; the "
              "paper's conv and enc-dec models run through build_model "
              "with train_codist / train_allreduce", file=sys.stderr)
        sys.exit(2)
    device = resolve_device(args.device)
    if args.mode == "codist-shardmap":
        # one process per model, joined by a gloo group; rank 0's History
        results = spawn_pods(shardmap_pod, args.codist_n, (argv,),
                             device=device)
        hist, dt = History(results[0]["records"]), results[0]["seconds"]
        state = None
    elif args.mode == "codist-async":
        obs = _obs(args)
        _train_async(args, build_model(cfg), _markov_task(args, cfg),
                     _train_config(args), device, obs)
        _save_obs(args, *obs)
        return
    else:
        obs = _obs(args)
        state, hist, dt = run_training(args, build_model(cfg), device,
                                       obs=obs[:3])

    for rec in hist.records:
        msg = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in rec.items()
                       if k in ("step", "task_loss", "distill_loss",
                                "eval_loss", "lr", "wd", "alpha",
                                "comm_bytes"))
        print(msg, flush=True)
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({dt / args.steps * 1e3:.0f} ms/step) on {device}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "history.json"), "w") as f:
            json.dump(hist.records, f, indent=1)
        if state is None:
            params = peer_params_to_numpy([r["params"] for r in results])
        elif args.mode == "allreduce":
            params = params_to_numpy(state.params)
        else:
            params = peer_params_to_numpy(state.params)
        save_pytree(os.path.join(args.out, "final"), params)
        print(f"wrote {args.out}/history.json and final checkpoint")
    if args.mode != "codist-shardmap":
        _save_obs(args, *obs)


def _train_async(args, model, task, tc: TrainConfig, device, obs) -> None:
    """``--mode codist-async``: the async runtime on a seeded fault
    schedule, one coordinated batch stream for every peer."""
    faults = parse_faults(args.faults, args.codist_n, seed=args.seed)
    if args.elastic > 0:
        faults = replace(faults, joins=((faults.n_peers, args.elastic),))
    codist = codist_config(args)

    def batches(step):
        return make_lm_batch(task, args.batch, args.seq, step, None,
                             seed=args.seed, device=device)

    ckpt_dir = None
    if args.checkpoint_every:
        ckpt_dir = os.path.join(args.out or ".", "runtime_ckpt")
    t0 = time.time()
    report = AsyncScheduler(
        model, tc, codist, batches, faults,
        staleness_bound=(None if args.staleness_bound < 0
                         else args.staleness_bound),
        checkpoint_dir=ckpt_dir, checkpoint_every=args.checkpoint_every,
        recover_after=(args.recover_after if args.checkpoint_every
                       else None),
        join_burn_in=args.join_burn_in, log_every=args.log_every,
        tracer=obs[0], metrics=obs[1], watch=obs[2], device=device).run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    for pid in sorted(report.histories):
        for rec in report.histories[pid].records:
            msg = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k in ("peer", "step", "task_loss", "distill_loss",
                         "staleness", "alpha", "sim_time"))
            print(msg, flush=True)
    print(f"sim_time={report.sim_time:.2f} "
          f"time_to_first={report.time_to_first:.2f} "
          f"comm_events={report.comm_events} "
          f"comm_bytes={report.comm_bytes:.0f} "
          f"staleness_mean={report.staleness['staleness_mean']:.3f} "
          f"dropped={report.staleness['payloads_dropped']}")
    print(f"done: {args.steps} steps x {faults.n_total} peers "
          f"in {dt:.1f}s (simulated {report.sim_time:.1f}s) on {device}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        report.save_histories(args.out)
        for pid, st in report.states.items():
            save_pytree(os.path.join(args.out, f"final_peer{pid}"),
                        st.params)
        print(f"wrote per-peer JSONL histories + checkpoints to {args.out}")


if __name__ == "__main__":
    main()
