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
                busy share are printed, and beside the bf16 tick's device
                time the cost model's FLOPs, bytes and bound
                (``launch/cost.py``, the H100 SXM's published peaks) and
                FlopCounterMode's count of one tick's GEMMs, held to the
                model's within 1%.
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
                torch.profiler, peak memory; the codist step's bound from
                the cost model beside its device time, and FlopCounterMode's
                count of one step's GEMMs held to the model's within 1%.
  8. train_peers — the same model and batch at PEERS_LAYERS (12) of 24
                layers (cut from 24 for the time budget) through
                ``train_codist`` with the other exchanges: (a) 3 peers, mse, 6 steps and an
                eval, then 2 kl steps (task loss must fall); (b) 2 peers,
                a subsample wire of 64 tokens, 2 mse and 2 kl steps; (c)
                the checkpoint exchange, 2 peers, period 2, 3 steps; (d)
                the pipelined exchange, 2 peers, 3 steps (alpha 0 on step
                0); (e) a top-k wire of 64, 2 peers, 2 steps. Launch counts
                per distilling step checked against codist_loss's loop;
                ms per step, device-busy share, peak memory.
  9. sweep    — the paper-grid harness at qwen1.5-0.5b's full width and
                SWEEP_LAYERS (12) of 24 layers (the depth cut keeps the
                script in its time budget): a YAML spec
                (model_overrides restoring get_config at that depth, batch 8 x
                seq 512 a peer, 10 steps, the five modes under a constant
                and a burn-in alpha: 9 cells) through
                ``repro_torch.launch.sweep.main``, then ``--resume`` (all
                skipped, nothing launched); per cell the task loss falls,
                the launches match the mode's loss loop and async
                comm_bytes is the wire's bytes times its deliveries; wall,
                ms per step, peak memory, the aggregate's gaps and codist
                steps/s per card.
 10. async    — ``AsyncScheduler`` at full width and 6 of 24 layers (the
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
                qwen2-7b's full width with the fleet phase's FleetConfig
                and bursty workload: identical peers over bf16 pools at
                SPEC_LAYERS (14) of 28 (cut from 28 for the time budget);
                a noised copy of peer 0 over bf16 pools and
                identical peers over int8 and fp8 pools and through the
                gather path at SPEC_CUT_LAYERS (7) of 28 (the time
                budget), each run plain and
                speculative (everything completes, nothing lost or
                duplicated, rows 1-4 launched exactly as the ticks and
                rounds imply; accept rate, tokens equal to the plain run's
                and wall per round against k plain ticks printed; for the
                identical bf16, int8 and fp8 streams each request's first
                divergence from the plain stream with the plain tick's
                top-2 logit margin there, against the verify's max
                |dlogits| at that pool dtype); a verify against k plain
                ticks on 16 live slots over bf16 pools at 14 layers and
                int8 and fp8 pools at the cut depth (printed); then in fp32
                (TF32 off) at 4 layers: speculative streams equal plain
                ones token for token, verify argmax equal to plain decode
                at every position, and restore_rows leaving the pools bit
                for bit as they were (fp32, gather path, int8, fp8).
 13. fleet_codist — qwen1.5-0.5b at full width and PEERS_LAYERS (12)
                of 24 layers (cut from 24 for the time budget): the async
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
 14. single   — dense serving (``Engine.generate``, ``LM.decode``; the
                CLI's ``--single``) at qwen2-7b's full width and depth,
                seeded bf16 weights and a bf16 cache, at batch 4 and 16,
                prompts of 64 and 16 new tokens: prefill ms, ms a decode
                step (wall) and its device-busy share (torch.profiler),
                tokens/s, two calls equal, no kernel launched (the dense
                attention is torch.matmul, as the reference's einsums);
                then in fp32 (TF32 off) at 4 of 28 layers: ragged equals
                per-request, a 48-token window over 64-token prompts (the
                ring wraps) within 5e-4 of the windowed teacher forcing, and
                the card's tokens equal the CPU's at the reduced config;
                ``--single`` through the CLI on the card; then
                transformer-big at full width and depth (6 + 6 layers,
                source tokens), whisper-tiny at full width and depth (4 +
                4 layers over 1500 frames) and internvl2-76b at full width
                and 8 of 80 layers (256 patch embeddings before the
                prompt), seeded bf16 weights and cache, through
                ``Engine.generate`` at batch 4: prefill ms, ms a decode
                step and its busy share, two calls equal, no kernel
                launched, peak memory; the reduced configs in fp32, card
                tokens equal the CPU's over frames, source tokens and
                patches; last ``--single --arch`` each (the reduced
                config, seeded frames or patches) through the CLI.
 15. obs      — the observability layer: (a) qwen2-7b at full width and
                OBS_LAYERS (14) of 28 layers (cut from 28 for the time
                budget), seeded bf16 weights, 2 peers, the fleet phase's
                FleetConfig and bursty workload under a straggler and a
                preemption, defended with hedging, obs off and on in turns
                (a warm-up, then off, on, on, off, off, on; on = a tracer,
                a registry, the default rules and a flight recorder):
                every file passes ``tools/trace_check.py``, the three
                on-runs write byte-identical files, all reports and launch
                counts are equal; wall a tick on and off with the spread,
                and the host time inside the hooks a tick; (b) the same at
                the reduced config in fp32, card against CPU: trace and
                alert log byte-equal; (c) ``codist-async`` at
                qwen1.5-0.5b's full width and 6 layers, kl, under the
                async faults (no recovery) with every obs output; (d) a
                2-cell sweep (all-reduce, codist; 3 steps at full width)
                through the sweep CLI with ``--trace --metrics --alerts``.
 16. paper    — the paper's own models at full width and depth through
                ``build_model`` and ``train_codist`` / ``train_allreduce``:
                resnet50 (2 peers x 8 images of 224^2, mse, 3 codist steps
                and 1 all-reduce step), wrn28x10 (2 peers x 128 images of
                32^2, mse, stem and stage 0 frozen by ``freeze_mask`` and
                bit-unchanged), transformer-big (2 peers x 14 x 256 source
                and target tokens, bf16 activations, fp32 masters, AdamW)
                and the Section-5.1 multi-view MLP (8 peers x 256, kl,
                each peer its own view): History finite, loss-kernel
                launches exact, ms a step, busy share, peak memory; rows 6,
                7, 12, 13 (and 9, 11) against their plain versions and
                timed at this path's shapes (T 8 / V 1000 and T 256 / V 10
                fp32, T 3584 / V 32768 bf16); then the reduced models in
                fp32 (TF32 off), card against CPU, History losses within
                1e-5 relative over 3 codist steps; row 7 at T 256 / V 10
                and its library backward timed in turns.
 17. families — the MoE and hybrid families at full width and the depth
                one card holds (grok-1 4 of 64 layers, arctic 2 of 35,
                jamba one 8-layer step of 32: seven Mamba sub-layers, one
                attention, four MoE FFNs), seeded bf16 weights, one model
                on the card at a time: a 2-peer fleet sharing one weight
                set (16 slots, 16 bursty requests, prompts <= 128) with
                rows 1 and 2 launched exactly once per attention
                sub-layer per tick, the same requests through
                ``Engine.generate`` at batch 4 (tokens compared, each first
                divergence with the fleet's top-2 margin; at least 75%
                equal, and the median first divergence at a margin within
                the tick check's 5% of max|logits|), a fused-vs-gather tick
                (row 3; a slot whose experts flip must flip at a router
                margin under 1e-2) and 5 timed ticks with their device
                profile, and for grok-1 the fleet over int8 pools (rows 1q,
                4); then grok-1 (1 of 64 layers) and internvl2 (1 of 80,
                after 256 seeded patch embeddings) trained at full width: 2
                peers x 512 tokens, bf16 weights, plain SGD, 3 codist steps
                (rows 12, 13 at V 131072 and 128256) and 1 all-reduce step
                (rows 6, 7), aux loss, ms a step, busy share, peak memory;
                last the
                reduced configs in fp32, card against CPU: 3 codist steps
                within 1e-5 relative and equal FleetReports.
 18. rwkv     — rwkv6-1.6b, attention-free (no paged pool, so rows 1-4
                launch 0 times on its path), at full width and depth (24
                layers, seeded bf16 weights; the leaves read in fp32 kept
                fp32): a 2-peer fleet sharing one weight set (16 slots, 16
                bursty requests, prompts <= 128, three of them on the
                64-token WKV chunk), the same requests through
                ``Engine.generate`` at batch 4 (tokens compared as in the
                families phase), 5 timed ticks of 16 live slots with their
                device profile, Engine.generate's prefill and decode step
                at batch 4 with its busy share, peak memory; then training
                at full width
                and RWKV_TRAIN_LAYERS (4) of 24 layers with each layer
                recomputed in the backward: 2 peers x 8 x 512 tokens, fp32
                masters, bf16, AdamW, 3 mse codist steps (rows 12, 13) and
                1 all-reduce step (rows 6, 7), launches exact, ms a step,
                busy share, peak memory; rows 6, 7, 12 and 13 held against
                their plain versions and timed at T 4096 / V 65536 bf16
                beside F.cross_entropy and its backward; last the reduced
                config in fp32, card against CPU: 3 codist steps within
                1e-5 relative, equal FleetReports, Engine.generate tokens
                equal (uniform at the chunk, and ragged).
 19. shardmap — ``--mode codist-shardmap``: 2 pods spawned on the one card
                (one process a model, a gloo group through a FileStore, the
                wire gathered through host memory) train through the
                training CLI's ``run_training`` and ``ShardMapCompressed``
                at qwen1.5-0.5b's full width and depth (fp32 masters, bf16,
                AdamW, 2 x 512 tokens a pod, 3 steps) over the none wire
                (rows 12 and 13 a pod a step) and the top-64 wire (rows 6,
                7); launches exact, the pods' Histories equal; wall and pod
                0's device ms a step, the exchange's share of a step, each
                pod's peak memory and the wire's bytes; then at 4 of 24
                layers in fp32 (TF32 off, SGD-momentum at lr 0.05 from step
                0) the losses within 1e-5 relative of ``--mode codist``
                (PredictionExchange) and the metered wire bytes equal to
                ``comm_bytes``; last the CLI itself on the card (reduced
                config).
 20. mesh     — the codist and all-reduce steps over DTensors on a 1-rank
                NCCL mesh (1, 1, 1) (``spawn_pods(..., mesh=)``):
                qwen1.5-0.5b at full width and 4 of 24 layers, fp32 (TF32
                off). Both peers placed on the pod's (data, model) devices
                by the sharding rules, ``PredictionExchange`` 3 steps
                against the plain step on the same card from the same
                weights and Markov batches: losses and every leaf within
                1e-6 relative, rows 12 and 13 launched once a peer a step.
                One model over the whole mesh, ``AllReduce`` 3 steps:
                losses and leaves bit-equal to the plain step's, rows 6 and
                7 once a step. One step of 2 microbatches of each against
                its plain step (1e-6), the rows once a microbatch. Then the
                paper's models, one step of each strategy bit-equal to its
                plain step: resnet50 at full size (2 peers of 8 images of
                224^2; the baseline's one model of 16) and transformer-big
                at full width and 2 of 6 encoder and decoder layers (2
                peers of 14 x 256 source and target tokens), lr 1e-3. Then
                jamba at full width and 2 of 32 layers (Mamba + dense FFN,
                then attention + a 16-expert MoE), every weight in bf16,
                plain SGD: one step of each strategy (2 peers of 1 x 512,
                the baseline's one model of 2 x 512), the placed step
                first, bit-equal to the plain step from the same draw
                (the MoE routes each rank's rows, the Mamba mixer runs on
                them). Every launch through the loss kernels' DTensor
                entry.

On request only (not in the default run): ``rows`` times rows 1, 1q, 2
and 4 at the main shapes and saves their outputs (``--dump``), and
``parent`` runs ``rows`` in four processes — a copy of the parent commit
in ``build/parent``, this tree twice, the parent —
requiring bit-equal outputs and printing the times side by side;
``bwd_rows`` and ``bwd_parent`` do the same for rows 7, 10, 11 and 13 (mse,
kl) through their public wrappers at the main path's shape (T 4096 / V
152064 bf16, a digest of each output's bits) and at the classifier rows.
``mesh4`` needs a host with 4 cards (``python3 chip_smoke.py --phases
device,build,mesh4``; fewer fail the phase) and spawns 4 ranks,
one card each, NCCL: qwen1.5-0.5b at 4 layers in fp32 on (2, 2, 1) (pod x
FSDP) and (2, 1, 2) (pod x TP) over the none and top-64 wires,
``ShardMapCompressed`` 3 steps held to the single-card
``PredictionExchange`` (losses 1e-4 relative, each rank's shard of every
leaf 1e-4 absolute, the loss moving by more than 100 times that), launches
exact, the pod gathers' bytes equal to ``comm_bytes``; then deepseek-67b at
full width and 4 of 95 layers (bf16 over fp32 masters, AdamW, 2 peers of 4
x 512 tokens on (2, 1, 2)), which one card cannot hold: finite moving
losses, wall and device ms a step, the NCCL gather's share of a step and
its bytes, each rank's peak memory. Then the all-reduce baseline and
microbatches: qwen1.5-0.5b's one model of 4 x 512 on (2, 2, 1) and (2, 1,
2), and 2 microbatches of both strategies (twice the rows) on (2, 2, 1),
each held to its single-card step (losses 1e-5 relative, shards 1e-4),
every rank's metered cross-pod bytes (the optimizer's reduction over
"pod", or the gather of the fp32 none wire) equal to ``launch/cost.py``'s
a step, as are the none-wire parity runs'; deepseek-67b's ``AllReduce`` of
8 x 512 rows on (2, 1, 2) with the cross-pod gradient all-reduce's ms and
bytes beside the codist step's; and rwkv6-1.6b at full width and depth
(remat) and internvl2-76b at full width and 2 of 80 layers with 256
numpy patches (plain SGD), codist on (2, 1, 2) in fp32, held to the
single card. Last the paper's models at full size in fp32, each held to
its single-card step the same way (losses 1e-5 relative, shards 1e-4,
launches, metered cross-pod bytes equal to ``launch/cost.py``'s): resnet50
(2 peers of 16 images of 224^2, lr 1e-3) and wrn28x10 (2 peers of 128 of
32^2, stem and stage 0 frozen by ``freeze_mask``, lr 1e-4) as codist and
as the baseline on (2, 2, 1); transformer-big (2 peers of 14 x 256) as
codist on (2, 1, 2) and (2, 2, 1) and as the baseline on (2, 1, 2);
whisper-tiny (2 peers of 4 x 64 over 1500 numpy frames) as codist on (2,
2, 1); with rank 0 under torch.profiler each prints its wall and device ms
a step, the cross-pod ms and bytes of both strategies and their ratio
(resnet50's beside the paper's b_model / b_pred) and each rank's peak;
then transformer-big in bf16 over fp32 masters with AdamW, both
strategies on (2, 1, 2), timed. Then the MoE and hybrid families at full
width (``mesh4moe``, which also runs alone: ``--phases
device,build,mesh4moe``), every weight in bf16, plain SGD, 2 peers of 2 x
512 (the baseline's one model of 4 x 512), 3 steps: grok-1 at 2 of 64
layers as codist on (2, 2, 1) with the experts over "data" (4 a rank,
rows to them by an all-to-all of capacity buffers) and without (FSDP
inside each expert), and as the baseline with them; arctic at 1 of 35 (128
experts, 64 a rank) as codist with them; jamba at 2 of 32 as codist on (2,
2, 1) with them and on (2, 1, 2) (TP), and as the baseline with them.
Each prints its wall and device ms a step, each rank's peak, and its
metered all-to-all and cross-pod bytes, both equal to ``launch/cost.py``'s;
grok-1's two codist placements agree within bf16's unit roundoff. In fp32
(remat), jamba as codist and as the baseline and grok-1's baseline at 1
layer, each held to the single card (losses 1e-5 relative, shards 1e-4).

The kernels phase also holds the decode (rows 1, 1q) at qwen1.5-4b's heads
(H = KVh = 20, hd 128, the fleet's slots and lengths: the kernel's head
groups) over fp32, bf16, int8 and fp8 pools, timed beside SDPA and its
bound, and rows 2 and 4 at its rows of 2,560 values (the quantizing
scatter's two-pass path), bit-exact, timed. It holds rows 1 and 1q the same
way at the families' heads, hd 128 over 8 KV heads: grok-1's 48 (G 6),
arctic's 56 (G 7) and jamba's 32 (G 4), and rows 2 and 4 at their rows of
1,024 values, bit-exact, timed; row 1 is also held and timed in bf16 at
those heads at the families tick's shape (16 slots, 10 blocks, the
contexts of the first 16 bursty prompts) beside SDPA on the gathered copy
and its bound. It also holds row 1 at the verify's shape (16 slots x k = 4
pseudo-slots, the plain tick's split plan): against the plain version at the
same plan, and each pseudo-slot bit for bit against the 16-slot decode; and
row 8 at the canary's shape, one (1, 152064) fp32 pair. Rows 8 (mse, kl) and
9, whose forward splits a row over a cluster of CTAs when the rows are few,
are held and timed at T = 1 (fp32, bf16), 16, 128, 512 and 4096 (V =
152064): at the plan's split count and forced to each cluster size 1-16
(1 is the parent's one CTA a row), two calls bit-equal; a mutant copy of
the kernel whose fold skips the rescale of each rank's sums, built beside
the kernels, must fail the check at the canary's shape in kl mode. Rows 7,
10, 11 and 13 (mse, kl), the backward, run at the paper's classifier rows
(T 8 / V 1000, T 64 / V 10 and T 256 / V 10 fp32, T 256 / V 1000 bf16):
each against the plain version, the wrapper's call equal to the
launcher's, one kernel a call and nothing else on the device
(torch.profiler), each timed beside the launch floor (a one-CTA ``zero_``).

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
          "fleet_codist", "single", "obs", "paper", "families", "rwkv",
          "shardmap", "mesh")
# run only when named: "rows" times rows 1, 1q, 2 and 4 at the main shapes
# and saves their outputs (--dump); "parent" runs "rows" in turns on a copy
# of the parent commit in PARENT and on this tree, and compares them;
# "bwd_rows" and "bwd_parent" do the same for the loss backward (rows 7,
# 10, 11, 13) at the main shape and the classifiers' rows; "mesh4" needs a
# host with 4 cards, and so does "mesh4moe" (mesh4's MoE and hybrid cases
# alone, which "mesh4" runs too)
ON_REQUEST = ("rows", "parent", "bwd_rows", "bwd_parent", "mesh4",
              "mesh4moe")
PARENT = os.path.join(ROOT, "build", "parent")

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


def loss_bound(kernel: str, t: int, v: int, es: int, mode: str = "mse",
               target_grad: bool = False):
    """(bound_ms, bound_by) of one launch of a loss row at T tokens of V
    logits of ``es`` bytes, by ``repro_torch.launch.cost``'s byte and
    operation rule (the one the cost model counts a step with)."""
    from repro_torch.launch import cost
    return cost.kernel_bound_ms(*cost.loss_kernel_io(
        kernel, t, v, es, target_grad, mode))


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
PATHS = {"paged_scatter": ("fleet", "spec", "fleet_codist", "obs",
                           "families"),
         "paged_gather": ("fleet", "spec", "families"),
         "paged_attention_decode": ("fleet", "spec", "fleet_codist", "obs",
                                    "families"),
         "paged_attention_decode_quant": ("fleet", "spec", "families"),
         "paged_scatter_quant": ("fleet", "spec", "families"),
         "fused_cross_entropy": ("ops",), "flash_attention": ("ops",),
         "fused_cross_entropy_parts": ("train", "train_peers", "sweep",
                                       "async", "obs", "paper", "families",
                                       "rwkv", "shardmap", "mesh", "mesh4",
                                       "mesh4moe"),
         "fused_cross_entropy_grad": ("train", "train_peers", "sweep",
                                      "async", "obs", "paper", "families",
                                      "rwkv", "shardmap", "mesh", "mesh4",
                                      "mesh4moe"),
         "fused_ce_distill_parts": ("train", "train_peers", "sweep", "obs",
                                    "paper", "families", "rwkv", "shardmap",
                                    "mesh", "mesh4", "mesh4moe"),
         "fused_ce_distill_grad": ("train", "train_peers", "sweep", "obs",
                                   "paper", "families", "rwkv", "shardmap",
                                   "mesh", "mesh4", "mesh4moe"),
         "fused_distill_loss": ("train_peers", "sweep", "fleet_codist"),
         "fused_distill_kl_parts": ("train_peers", "async", "obs", "paper"),
         "fused_distill_mse_grad": ("train_peers", "sweep"),
         "fused_distill_kl_grad": ("train_peers", "async", "obs", "paper")}

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
    report_loss_build(info["fused_losses"]["log"])


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
            part = re.search(
                r"decode_partial_kernelI(\w+?)Li(\d+)ELi(\d+)ELb([01])E",
                mangled)
            comb = re.search(r"decode_combine_kernelI(\w+?)EEv", mangled)
            fn = (("partial", DECODE_POOLS.get(part.group(1), part.group(1)),
                   f"hd {part.group(2)} GP {part.group(3)}"
                   f"{' grouped' if part.group(4) == '1' else ''}") if part else
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


def report_loss_build(nvcc_log: str) -> None:
    """Registers and spills of each loss forward instance (fwd_kernel<dtype,
    mode, split>) from a fresh build's ``-Xptxas -v``; fails on a spill."""
    if not nvcc_log:
        log("  loss forward kernels: cached build, no ptxas log")
        return
    rows, fn, spill, spilled = [], None, 0, []
    for line in nvcc_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"fwd_kernelI(\w+?)Li(\d)ELb([01])E",
                          line.split("'")[1])
            fn = (f"{DECODE_POOLS.get(m.group(1), m.group(1))} mode "
                  f"{m.group(2)}{' split' if m.group(3) == '1' else ''}"
                  if m else None)
        elif fn and "spill" in line:
            spill = sum(map(int, re.findall(r"(\d+) bytes spill", line)))
        elif fn and "Used" in line:
            rows.append(f"{fn} {int(line.split('Used')[1].split()[0])}/{spill}")
            if spill:
                spilled.append(fn)
            fn = None
    log("  fwd_kernel (registers/spill bytes): " + ", ".join(sorted(rows)))
    require(rows, "no loss forward kernel in the ptxas log")
    require(not spilled, f"loss forward kernels spill: {spilled}")


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
# held (label, slots, MB, NB, lengths, H, KVh, hd): qwen1.5-0.5b's heads
# (H = KVh = 16, hd = 64: G = 1, one warp per KV head), G = 4 at hd 64 and
# G = 8 at hd 32, whose chunks take 2 and 1 steps (an inactive slot and a
# full table among them), and qwen1.5-4b's heads (H = KVh = 20, hd 128: the
# kernel splits them into head groups) at the fleet's slots and lengths,
# the one of them also timed (TIMED_CHECKS); and the families' heads at the
# fleet's slots and lengths, hd 128 over 8 KV heads: grok-1 48 (G 6),
# arctic 56 (G 7), jamba 32 (G 4)
DECODE_CHECKS = [("qwen1.5-0.5b", 4, 8, 16, [0, 5, 40, 127], 16, 16, 64),
                 ("hd64 G4", 3, 6, 12, [0, 17, 95], 8, 2, 64),
                 ("hd32 G8", 3, 6, 12, [0, 17, 95], 8, 1, 32),
                 ("qwen1.5-4b", S, MB, NB, LENGTHS, 20, 20, 128),
                 ("grok-1", S, MB, NB, LENGTHS, 48, 8, 128),
                 ("arctic", S, MB, NB, LENGTHS, 56, 8, 128),
                 ("jamba", S, MB, NB, LENGTHS, 32, 8, 128)]
TIMED_CHECKS = ("qwen1.5-4b",)
# row 1 alone at the families' heads (hd 128 over 8 KV heads) and at their
# tick's shape: 16 slots of family_fleet_config's 10 blocks, contexts the
# prompt lengths of the first 16 requests of that arch's bursty workload
FAMILY_HEADS = [("grok-1-314b", 48, 8), ("arctic-480b", 56, 8),
                ("jamba-v0.1-52b", 32, 8)]


def family_tick_lengths(arch: str) -> list:
    """The contexts of the families phase's 16-slot tick for ``arch``."""
    from repro_torch.configs import get_config
    from repro_torch.serve.fleet import generate_workload
    wl = generate_workload("bursty", FAMILY_REQUESTS,
                           get_config(arch).padded_vocab, seed=5,
                           max_prompt=FAMILY_PROMPT, max_new=FAMILY_NEW)
    return [len(r.prompt) for r in wl.requests[:S]]


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
    kvh, hd = k.shape[2], k.shape[3]
    n_live = ((lengths + BS) // BS).clamp(max=mb).to(torch.int32)
    kx, vx = (paged_gather(x, table, n_live).view(s, mb * BS, kvh, hd)
              .permute(0, 2, 1, 3).repeat_interleave(q.shape[1] // kvh, dim=1)
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
    from repro_torch.launch.cost import kernel_bound_ms, paged_decode_io
    rows = int((lengths.long() + 1).sum())
    b_ms, b_by = kernel_bound_ms(*paged_decode_io(
        lengths.tolist(), q.shape[1], kp.shape[2], kp.shape[3],
        kp.element_size(), q.element_size(), table.shape[1], bool(scales),
        byte_rows), PEAK_FLOPS[kp.dtype])

    sc = scales or (None, None)

    def kern():
        return paged_attention_decode(q, kp, vp, table, lengths, *sc,
                                      plan_slots=plan_slots)

    r = {"ms": time_ms(kern, flush),
         "plain_ms": time_ms(lambda: paged_attention_decode_plain(
             q, kp, vp, table, lengths, *sc, bps), flush,
             iters=plain_iters, warmup=min(3, plain_iters)),
         "library_ms": None if lib is None else time_ms(lib, flush),
         "bound_ms": b_ms, "bound_by": b_by}
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
    from repro_torch.launch.cost import kernel_bound_ms, paged_gather_io
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
        bytes_gather = paged_gather_io(live_blocks, S, MB, block_b)
        gather = (lambda: paged_gather(kk, table, n_live),
                  lambda: paged_gather_plain(kk, table, n_live),
                  lambda: kk.index_select(0, flat_table))
        r = results["paged_gather"] = {
            "ms": time_ms(gather[0], flush), "plain_ms": time_ms(gather[1], flush),
            "library_ms": time_ms(gather[2], flush),
            "bound_ms": kernel_bound_ms(bytes_gather, 0)[0],
            "bound_by": "bytes", "max_abs_err": 0.0}
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
        if label in TIMED_CHECKS:
            time_decode(f"paged_attention_decode {label} bf16 (S={slots}, "
                        f"H={h}, KVh={kvh}, hd={hd}, MB={mb})", qd, kd, vd,
                        table, lengths, (), flush,
                        sdpa_on_gather(qd, kd, vd, table, lengths))
        del q, k, v, qd, kd, vd
    heads = {}
    mb = family_fleet_config().max_blocks_per_slot
    for arch, h, kvh in FAMILY_HEADS:
        lens = family_tick_lengths(arch)
        q, k, v, table, lengths = decode_inputs(S, mb, NB, lens, dev, 620, h,
                                                kvh, HD)
        qd, kd, vd = (x.to(torch.bfloat16) for x in (q, k, v))
        err = check_decode(f"{arch} tick bf16",
                           paged_attention_decode(qd, kd, vd, table, lengths),
                           paged_attention_decode_plain(qd, kd, vd, table,
                                                        lengths),
                           lengths, False, faults)
        heads[arch] = dict(time_decode(
            f"paged_attention_decode {arch} tick bf16 (S={S}, H={h}, "
            f"KVh={kvh}, hd={HD}, MB={mb}, contexts {min(lens)}..{max(lens)})",
            qd, kd, vd, table, lengths, (), flush,
            sdpa_on_gather(qd, kd, vd, table, lengths)), max_abs_err=err)
        del q, k, v, qd, kd, vd
    results["paged_attention_decode"]["heads"] = heads
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
            if label in TIMED_CHECKS:
                time_decode(f"paged_attention_decode_quant {label} "
                            f"{str(qdt)[6:]} (bf16 q, S={slots}, H={h}, "
                            f"KVh={kvh}, hd={hd}, MB={mb})", qq, kq, vq, table,
                            lengths, (ks, vs), flush, None)
            del kq, ks, vq, vs
        del q, k, v
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


def scatter_inputs(nb: int, dev: torch.device, seed: int, kvh: int = KVH,
                   hd: int = HD):
    """fp32 K and V pools (NB, BS, KVh, hd) made on the card from a seeded
    generator (null block 0 zero, the poisoned block NaN), S fp32 rows each
    for K and V, and write maps with 15 writers (slot 0 inactive): slots
    1..7 in blocks 4 s + 2 (one 4-entry column of the map, so one ballot
    holds all seven), 8..14 in random blocks, 15 in block NB - 1; offsets 0
    (slot 1) and BS - 1 (slots 2 and 15) among them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k, v = (torch.randn((nb, BS, kvh, hd), generator=gen, device=dev)
            for _ in range(2))
    for x in (k, v):
        x[0] = 0.0
        x[POISON] = float("nan")
    k_new, v_new = (torch.randn((S, kvh, hd), generator=gen, device=dev)
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


def random_quant_pool(nb: int, dtype, dev: torch.device, gen, kvh: int = KVH,
                      hd: int = HD):
    """A quantized pool of random bytes and its random fp32 scales: the null
    block 0 and scale 0, the poisoned block NaN scales (and NaN fp8 rows)."""
    q = torch.randint(-128, 128, (nb, BS, kvh, hd), generator=gen, device=dev,
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
    from repro_torch.launch.cost import kernel_bound_ms, paged_scatter_io
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
                 "bound_ms": kernel_bound_ms(nbytes, 0)[0],
                 "bound_by": "bytes", "max_abs_err": 0.0, "floor_ms": floor}
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
            paged_scatter_io(writers, row_b, nb))
        r4 = {}
        for qdt, (kq, ks, vq, vs) in qpools.items():
            qrow_b = KVH * HD * qdt.itemsize + 4       # payload + scale
            r4[qdt] = timed(
                f"paged_scatter_quant {str(qdt)[6:]} (bf16 rows)",
                lambda: paged_scatter_quant_kv(kq, ks, vq, vs, kn, vn, ws, wo),
                lambda: paged_scatter_quant(kq, ks, kn, ws, wo),
                lambda: paged_scatter_quant_kv_plain(kq, ks, vq, vs, kn, vn,
                                                     ws, wo),
                None, paged_scatter_io(writers, row_b, nb, qrow_b))
        log("\n".join(lines))
        if label == "main":
            results["paged_scatter"] = r2
            results["paged_scatter_quant"] = r4[torch.int8]
        del kb, vb, qpools
        torch.cuda.empty_cache()
    for kvh, hd, seed in LONG_ROWS:
        scatter_long_rows(dev, flush, faults, kvh, hd, seed)
    require(not faults, f"{len(faults)} scatter checks failed: "
            + "; ".join(faults))
    return results


# (KV heads, hd, seed) of the pool rows held beside the main path's:
# qwen1.5-4b's 20 x 128 = 2,560 values, past the 2,048 that one warp of the
# quantizing scatter holds in registers, and the families' (grok-1, arctic,
# jamba) 8 x 128 = 1,024
LONG_ROWS = [(20, 128, 730), (8, 128, 740)]


def scatter_long_rows(dev: torch.device, flush: torch.Tensor, faults,
                      kvh: int, hd: int, seed: int) -> None:
    """Rows 2 and 4 at rows of ``kvh`` x ``hd`` values in the fleet's pool
    (NB = 1025): the K+V scatter over fp32 and bf16 pools and the quantizing
    K+V scatter (its two-pass path) over int8 and fp8 pools from fp32 and
    bf16 rows, 16-byte aligned and not, bit for bit against the plain
    versions (null and poisoned blocks untouched); then the times of both
    K+V launches from bf16 rows beside the plain versions and the bound.
    Failures go into ``faults``."""
    from repro_torch.kernels import (paged_scatter_kv, paged_scatter_kv_plain,
                                     paged_scatter_quant_kv,
                                     paged_scatter_quant_kv_plain)
    from repro_torch.launch.cost import kernel_bound_ms, paged_scatter_io
    k, v, k_new, v_new, ws, wo = scatter_inputs(NB, dev, seed, kvh, hd)
    writers = int((ws >= 0).sum())
    label = f"rows of {kvh * hd} (NB={NB})"
    for dtype in (torch.float32, torch.bfloat16):
        kd, vd, kn, vn = (x.to(dtype) for x in (k, v, k_new, v_new))
        got, want = (kd.clone(), vd.clone()), (kd.clone(), vd.clone())
        paged_scatter_kv(*got, kn, vn, ws, wo)
        paged_scatter_kv_plain(*want, kn, vn, ws, wo)
        sync(dev)
        scatter_faults(f"paged_scatter_kv {label} {str(dtype)[6:]}",
                       [(got[0], want[0], kd), (got[1], want[1], vd)], faults)
        del kd, vd, got, want
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    qpools = {qdt: (*random_quant_pool(NB, qdt, dev, gen, kvh, hd),
                    *random_quant_pool(NB, qdt, dev, gen, kvh, hd))
              for qdt in QUANT}
    rows = [(str(r)[6:], k_new.to(r), v_new.to(r), ws, wo)
            for r in (torch.float32, torch.bfloat16)]
    rows.append(("bfloat16 unaligned", *(off16(x, dev) for x in (
        k_new.to(torch.bfloat16), v_new.to(torch.bfloat16), ws, wo))))
    for qdt, pools in qpools.items():
        for rname, kn, vn, wsx, wox in rows:
            got = [x.clone() for x in pools]
            want = [x.clone() for x in pools]
            paged_scatter_quant_kv(*got, kn, vn, wsx, wox)
            paged_scatter_quant_kv_plain(*want, kn, vn, ws, wo)
            sync(dev)
            scatter_faults(f"paged_scatter_quant_kv {label} {str(qdt)[6:]} "
                           f"from {rname} rows",
                           list(zip(got, want, pools)), faults)
            del got, want
    log(f"kernels scatter {label}, {writers} writers: K+V (fp32, bf16) and "
        "quantizing K+V (int8, fp8 from fp32, bf16 and unaligned bf16 rows) "
        "checked")
    kb, vb, kn, vn = (x.to(torch.bfloat16) for x in (k, v, k_new, v_new))
    del k, v
    row_b = kvh * hd * 2
    r2 = (time_ms(lambda: paged_scatter_kv(kb, vb, kn, vn, ws, wo), flush),
          time_ms(lambda: paged_scatter_kv_plain(kb, vb, kn, vn, ws, wo),
                  flush, iters=10),
          kernel_bound_ms(paged_scatter_io(writers, row_b, NB), 0)[0])
    log(f"  paged_scatter {label} bf16: K+V kernel {r2[0]:.4f} ms  plain "
        f"{r2[1]:.4f} ms  bound {r2[2]:.7f} ms (bytes)")
    for qdt, (kq, ks, vq, vs) in qpools.items():
        qrow_b = kvh * hd * qdt.itemsize + 4
        r4 = (time_ms(lambda: paged_scatter_quant_kv(kq, ks, vq, vs, kn, vn,
                                                     ws, wo), flush),
              time_ms(lambda: paged_scatter_quant_kv_plain(
                  kq, ks, vq, vs, kn, vn, ws, wo), flush, iters=10),
              kernel_bound_ms(paged_scatter_io(writers, row_b, NB, qrow_b),
                              0)[0])
        log(f"  paged_scatter_quant {label} {str(qdt)[6:]} (bf16 rows): K+V "
            f"kernel {r4[0]:.4f} ms  plain {r4[1]:.4f} ms  bound "
            f"{r4[2]:.7f} ms (bytes)")
    del kb, vb, qpools
    torch.cuda.empty_cache()


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
        b_ms, b_by = loss_bound("fused_cross_entropy", t, v, es)
        results["fused_cross_entropy"] = {
            "ms": time_ms(lambda: fused_cross_entropy(x, lb), flush, iters=20),
            "plain_ms": time_ms(lambda: fused_cross_entropy_plain(x, lb),
                                flush, iters=5, warmup=1),
            "library_ms": time_ms(lambda: F.cross_entropy(
                x, lb64, reduction="none"), flush, iters=20),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
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
        lb64 = lb.long()
        xr = x.detach().clone().requires_grad_(True)
        lib_y = F.cross_entropy(xr, lb64, reduction="none")
        (o_mse, r_mse) = fused_ce_distill_parts_plain(x, tg, lb, "mse")

        def bound(kname, mode="mse", target_grad=False):
            return loss_bound(kname, t, v, es, mode, target_grad)

        specs = {
            "fused_cross_entropy_parts": (
                lambda: fused_cross_entropy_parts(x, lb),
                lambda: fused_cross_entropy_parts_plain(x, lb),
                lambda: F.cross_entropy(x, lb64, reduction="none"),
                bound("fused_cross_entropy_parts")),
            "fused_cross_entropy_grad": (
                lambda: fused_cross_entropy_grad(x, lb, logz, g[0], g[1]),
                lambda: fused_cross_entropy_grad_plain(x, lb, logz, g[0], g[1]),
                lambda: torch.autograd.grad(lib_y, xr, g[0], retain_graph=True),
                bound("fused_cross_entropy_grad")),
            "fused_ce_distill_parts": (
                lambda: fused_ce_distill_parts(x, tg, lb, "mse"),
                lambda: fused_ce_distill_parts_plain(x, tg, lb, "mse"),
                None, bound("fused_ce_distill_parts")),
            "fused_ce_distill_grad": (
                lambda: fused_ce_distill_grad(x, tg, lb, r_mse, g[0], g[1],
                                              g[2], "mse",
                                              need_target_grad=False),
                lambda: fused_ce_distill_grad_plain(x, tg, lb, r_mse, g[0],
                                                    g[1], g[2], "mse",
                                                    need_target_grad=False),
                None, bound("fused_ce_distill_grad")),
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
                bound("fused_ce_distill_parts", "kl")),
            "fused_ce_distill_grad kl": (
                lambda: fused_ce_distill_grad(x, tg, lb, r_kl, g[0], g[1],
                                              g[2], "kl",
                                              need_target_grad=False),
                bound("fused_ce_distill_grad", "kl")),
            "fused_ce_distill_grad mse with dt": (
                lambda: fused_ce_distill_grad(x, tg, lb, r_mse, g[0], g[1],
                                              g[2], "mse"),
                bound("fused_ce_distill_grad", target_grad=True)),
        }
        for kname, (kern, (b_ms, b_by)) in extra.items():
            log(f"  {kname} bf16: kernel {time_ms(kern, flush, iters=20):.4f}"
                f" ms  bound {b_ms:.4f} ms ({b_by})")
        del xr, lib_y
    torch.cuda.empty_cache()
    return results


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

        def bound(kname, mode="mse", target_grad=False):
            return loss_bound(kname, t, v, es, mode, target_grad)

        if label == "canary":
            b_ms, b_by = bound("fused_distill_loss")
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
                bound("fused_distill_loss")),
            "fused_distill_kl_parts": (
                lambda: fused_distill_kl_parts(x, tg),
                lambda: fused_distill_kl_parts_plain(x, tg),
                None, bound("fused_distill_kl_parts")),
            "fused_distill_mse_grad": (
                lambda: fused_distill_mse_grad(x, tg, gd,
                                               need_target_grad=False),
                lambda: fused_distill_mse_grad_plain(x, tg, gd,
                                                     need_target_grad=False),
                lambda: torch.autograd.grad(lib_mse, xr, retain_graph=True),
                bound("fused_distill_mse_grad")),
            "fused_distill_kl_grad": (
                lambda: fused_distill_kl_grad(x, tg, *res, gd,
                                              need_target_grad=False),
                lambda: fused_distill_kl_grad_plain(x, tg, *res, gd,
                                                    need_target_grad=False),
                None, bound("fused_distill_kl_grad")),
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
                bound("fused_distill_loss", "kl")),
            "fused_distill_mse_grad with dB": (
                lambda: fused_distill_mse_grad(x, tg, gd),
                bound("fused_distill_mse_grad", target_grad=True)),
            "fused_distill_kl_grad with dB": (
                lambda: fused_distill_kl_grad(x, tg, *res, gd),
                bound("fused_distill_kl_grad", target_grad=True)),
        }
        for kname, (kern, (b_ms, b_by)) in extra.items():
            log(f"  {kname} {label} (T={t}) bf16: kernel "
                f"{time_ms(kern, flush, iters=20):.4f} ms  bound {b_ms:.4f} "
                f"ms ({b_by})")
        del xr, lib_mse
    torch.cuda.empty_cache()
    return results


# the distillation forward's split over a cluster of CTAs (rows 8 and 9):
# the canary's one row (fp32, and bf16), a few rows, the subsample wire's
# 512 and the main path's 4096, at the full vocab
SPLIT_SHAPES = [("canary", 1, torch.float32), ("canary bf16", 1, torch.bfloat16),
                ("T=16", 16, torch.bfloat16), ("T=128", 128, torch.bfloat16),
                ("subsample", SUB_T, torch.bfloat16),
                ("main", TRAIN_T, torch.bfloat16)]
# every cluster size the kernel takes, each timed beside the plan's
SPLIT_COUNTS = (1, 2, 4, 8, 16)
# the mutant of the split forward: rank 0 folds each rank's state without
# the exp(m_r - M) rescale of s, st and u (the fold keeps rank 0's maxes)
MUTANT_FROM = "for (int r = 1; r < splits; ++r) merge<MODE>(a, parts[r]);"
MUTANT_TO = ("for (int r = 1; r < splits; ++r) { State b = parts[r]; "
             "b.m = a.m; b.mt = a.mt; merge<MODE>(a, b); }")


def start_mutant_build():
    """Start nvcc on a copy of ``fused_losses.cu`` with the mutant fold
    (``build/mutant``); returns (process, library path)."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "fused_losses.cu").read_text()
    require(src.count(MUTANT_FROM) == 1,
            "the split fold's line is not in fused_losses.cu exactly once")
    out = _build.BUILD / "mutant"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "fused_losses_mutant.cu", out / "fused_losses_mutant.so"
    cu.write_text(src.replace(MUTANT_FROM, MUTANT_TO))
    proc = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                             str(so), str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so


def as_rows(out) -> torch.Tensor:
    """A (T,) output or a tuple of them as (K, T) rows."""
    return torch.stack(out) if isinstance(out, tuple) else out[None]


def phase_distill_splits(dev: torch.device, flush: torch.Tensor, mutant):
    """Rows 8 (mse, kl) and 9 at SPLIT_SHAPES: the plan's splits, the
    kernel at the plan and forced to each cluster size of SPLIT_COUNTS
    through the C entry (1: the parent's one CTA a row), each held against
    the plain version; two calls bit-equal; the plain version, F.mse_loss
    (mse) and the bound. Then the mutant fold must fail the check at the
    canary's shape in kl mode. Returns {kernel: [a record a shape]}."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.distill_loss import (distill_fwd_split_plan,
                                                  fused_distill_kl_parts,
                                                  fused_distill_kl_parts_plain,
                                                  fused_distill_loss,
                                                  fused_distill_loss_plain,
                                                  fwd_runs, launch_fwd)
    from repro_torch.kernels.paged_attention import _num_sms
    sms = _num_sms(dev.index if dev.index is not None
                   else torch.cuda.current_device())
    errs, out = {}, {"fused_distill_loss": [], "fused_distill_kl_parts": []}
    v = TRAIN_V
    for si, (label, t, dtype) in enumerate(SPLIT_SHAPES):
        x, tg, _lb, _g = loss_inputs(t, v, dtype, dev, 300 + si)
        es = x.element_size()
        fp32 = dtype == torch.float32
        plan = distill_fwd_split_plan(t, v, es, sms)
        # (row, mode): wrapper, the C entry at a plan, plain, library
        specs = {
            ("fused_distill_loss", "mse"): (
                lambda: fused_distill_loss(x, tg, "mse"),
                lambda pl: launch_fwd("distill_mse", x, tg, None, v,
                                      plan=pl)[:1],
                lambda: fused_distill_loss_plain(x, tg, "mse"),
                lambda: F.mse_loss(x, tg)),
            ("fused_distill_loss", "kl"): (
                lambda: fused_distill_loss(x, tg, "kl"),
                lambda pl: launch_fwd("distill_kl", x, tg, None, v,
                                      plan=pl)[:1],
                lambda: fused_distill_loss_plain(x, tg, "kl"), None),
            ("fused_distill_kl_parts", "kl"): (
                lambda: fused_distill_kl_parts(x, tg),
                lambda pl: launch_fwd("distill_kl", x, tg, None, v,
                                      residuals=True, plan=pl),
                lambda: fused_distill_kl_parts_plain(x, tg), None),
        }
        slow = t == TRAIN_T
        for (name, mode), (kern, forced, plain, lib) in specs.items():
            what = f"{name} {mode} {label} (T={t}, {str(dtype)[6:]})"
            want, got = as_rows(plain()), as_rows(kern())
            require(bits_equal(got, as_rows(kern())),
                    f"{what}: two calls on the same inputs differ")
            for a, b in zip(got, want):
                check_loss_output(name, label, a, b, False, fp32, errs)
            err = max_err(got, want)
            per_split = {}
            for k in SPLIT_COUNTS:
                pl = fwd_runs(v, es, k)
                for a, b in zip(forced(pl), want):
                    check_loss_output(name, f"{label} splits {k}", a, b,
                                      False, fp32, errs)
                per_split[k] = time_ms(lambda: forced(pl), flush)
            b_ms, b_by = loss_bound(name, t, v, es, mode)
            r = {"shape": label, "T": t, "V": v, "dtype": str(dtype)[6:],
                 "mode": mode, "splits": plan[1], "vecs_per_split": plan[0],
                 "ms": time_ms(kern, flush),
                 "one_split_ms": per_split[1],
                 "split_ms": {str(k): ms for k, ms in per_split.items()},
                 "plain_ms": time_ms(plain, flush, iters=3 if slow else 10,
                                     warmup=1),
                 "library_ms": None if lib is None else time_ms(lib, flush),
                 "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
            out[name].append(r)
            lib_txt = ("" if r["library_ms"] is None
                       else f"  F.mse_loss {r['library_ms']:.4f} ms")
            log(f"  {what}: plan {plan[1]} splits of {plan[0]} vectors: "
                f"kernel {r['ms']:.4f} ms (one split {per_split[1]:.4f}; "
                + ", ".join(f"{k}: {ms:.4f}" for k, ms in per_split.items())
                + f")  plain {r['plain_ms']:.4f} ms{lib_txt}  bound "
                f"{r['bound_ms']:.5f} ms ({r['bound_by']})  max|kernel-plain| "
                f"{err:.2e}")
            if label == "canary" and mode == "mse":
                met = r["ms"] < r["library_ms"] and r["ms"] <= 0.010
                log(f"  canary mse: kernel {r['ms']:.4f} ms vs F.mse_loss "
                    f"{r['library_ms']:.4f} ms and 0.010 ms: "
                    f"{'met' if met else 'NOT met'}")
        if label == "canary":
            # the mutant fold, through the same wrapper, must fail
            proc, so = mutant
            log_txt, _ = proc.communicate()
            require(proc.returncode == 0, f"mutant build failed:\n{log_txt}")
            real = _build.load("fused_losses")
            _build._libs["fused_losses"] = _build.bind(so, "fused_losses")
            try:
                bad = fused_distill_loss(x, tg, "kl")
            finally:
                _build._libs["fused_losses"] = real
            sync(dev)
            try:
                check_loss_output("fused_distill_loss", "mutant", bad,
                                  fused_distill_loss_plain(x, tg, "kl"),
                                  False, True, {})
            except SmokeFailure as e:
                log(f"  mutant without the fold's rescale fails as it "
                    f"should: {e}")
            else:
                raise SmokeFailure("the mutant split fold passed the check "
                                   "at the canary's shape (kl)")
        del x, tg
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------------
# the loss backward (rows 7, 10, 11, 13) at the classifiers' rows
# ----------------------------------------------------------------------------

# the paper's classifier rows, one an example: resnet50's 1000 classes at 8
# images a peer, wrn28x10's 10 at a rank's 64 (mesh4) and the MLP's 10 at 256
# samples, all fp32; and 1000 classes in bf16
BWD_NARROW_SHAPES = [("T8 V1000 fp32", 8, 1000, torch.float32),
                     ("T64 V10 fp32", 64, 10, torch.float32),
                     ("T256 V10 fp32", 256, 10, torch.float32),
                     ("T256 V1000 bf16", 256, 1000, torch.bfloat16)]
# the main path's shape
BWD_MAIN = ("T4096 V152064 bf16", TRAIN_T, TRAIN_V, torch.bfloat16)
# rows 11 and 13 at the fp32 classifier rows: about 1.3x the launch floor
BWD_NARROW_TARGET_MS = 0.0065


def bwd_forward_rows(x, tg, lb) -> dict:
    """The residual rows of rows 7, 11 and 13 by backward mode, as the paths
    hand them over: views of the kernel forwards' (K, T) outputs (public
    wrappers only)."""
    from repro_torch.kernels import (fused_ce_distill_parts,
                                     fused_cross_entropy_parts,
                                     fused_distill_kl_parts)
    return {"ce": (fused_cross_entropy_parts(x, lb)[2],),
            "mse": fused_ce_distill_parts(x, tg, lb, "mse")[1],
            "kl": fused_ce_distill_parts(x, tg, lb, "kl")[1],
            "distill_mse": (),
            "distill_kl": fused_distill_kl_parts(x, tg)[1:]}


def bwd_wrapper_calls(x, tg, lb, g, res: dict, need_dt: bool) -> list:
    """(kernel, backward mode, call) of rows 7, 10, 11 and 13 (mse, kl)
    through their public wrappers, the target's gradient as ``need_dt``
    says (row 7 has none)."""
    from repro_torch.kernels import (fused_ce_distill_grad,
                                     fused_cross_entropy_grad,
                                     fused_distill_kl_grad,
                                     fused_distill_mse_grad)
    return [
        ("fused_cross_entropy_grad", "ce", lambda: fused_cross_entropy_grad(
            x, lb, *res["ce"], g[0], g[1])),
        ("fused_distill_mse_grad", "distill_mse",
         lambda: fused_distill_mse_grad(x, tg, g[2],
                                        need_target_grad=need_dt)),
        ("fused_distill_kl_grad", "distill_kl", lambda: fused_distill_kl_grad(
            x, tg, *res["distill_kl"], g[2], need_target_grad=need_dt)),
        ("fused_ce_distill_grad", "mse", lambda: fused_ce_distill_grad(
            x, tg, lb, res["mse"], g[0], g[1], g[2], "mse",
            need_target_grad=need_dt)),
        ("fused_ce_distill_grad", "kl", lambda: fused_ce_distill_grad(
            x, tg, lb, res["kl"], g[0], g[1], g[2], "kl",
            need_target_grad=need_dt))]


def bwd_key(label: str, mode: str) -> str:
    """A shape's label, with row 13's distillation mode."""
    return f"{label} {mode}" if mode in ("mse", "kl") else label


def phase_bwd_narrow(dev: torch.device, flush: torch.Tensor) -> dict:
    """Rows 7, 10, 11 and 13 (mse, kl) at BWD_NARROW_SHAPES through
    ``launch_bwd`` from the kernel forwards' residual rows: ds and dt within
    ``check_loss_output``'s tolerance of the plain version, the public
    wrapper's call bit-equal to the launcher's; one kernel a call and no
    other device work (torch.profiler); each call's time beside the launch
    floor (a one-CTA ``zero_`` timed the same way), the plain version's and
    the bound. Returns {kernel: {shape: record}}."""
    from repro_torch.kernels import (fused_ce_distill_grad_plain,
                                     fused_cross_entropy_grad_plain,
                                     fused_distill_kl_grad_plain,
                                     fused_distill_mse_grad_plain)
    from repro_torch.kernels.fused_ce import launch_bwd
    floor_buf = torch.zeros(1, device=dev)
    out = {}
    for si, (label, t, v, dtype) in enumerate(BWD_NARROW_SHAPES):
        x, tg, lb, g = loss_inputs(t, v, dtype, dev, 400 + si)
        es, fp32 = x.element_size(), dtype == torch.float32
        res = bwd_forward_rows(x, tg, lb)
        grads = {"ce": (g[0], g[1]), "mse": (g[0], g[1], g[2]),
                 "kl": (g[0], g[1], g[2]), "distill_mse": (g[2],),
                 "distill_kl": (g[2],)}

        def launch(mode, need_dt):
            ce = mode in ("ce", "mse", "kl")
            return launch_bwd(mode, x, None if mode == "ce" else tg,
                              lb if ce else None, res[mode], grads[mode], v,
                              need_dt and mode != "ce")

        def plain(mode, need_dt):
            if mode == "ce":
                return fused_cross_entropy_grad_plain(x, lb, *res["ce"], g[0],
                                                      g[1]), None
            if mode == "distill_mse":
                return fused_distill_mse_grad_plain(
                    x, tg, g[2], need_target_grad=need_dt)
            if mode == "distill_kl":
                return fused_distill_kl_grad_plain(
                    x, tg, *res[mode], g[2], need_target_grad=need_dt)
            return fused_ce_distill_grad_plain(
                x, tg, lb, res[mode], *grads[mode], mode,
                need_target_grad=need_dt)

        floor = time_ms(floor_buf.zero_, flush)
        calls = []
        for name, mode, wrapper in bwd_wrapper_calls(x, tg, lb, g, res,
                                                     need_dt=False):
            key = bwd_key(label, mode)
            ds, dt = launch(mode, True)
            ds_p, dt_p = plain(mode, True)
            err = check_loss_output(name, key, ds, ds_p, True, fp32, {})
            if dt_p is not None:
                err = max(err, check_loss_output(name, key, dt, dt_p, True,
                                                 fp32, {}))
            # the wrapper asks for no dt, as the paths do: held to the
            # launcher called so (without dt, mse's ds = ce + dd may fuse
            # dd's product into an fma; with dt, dd is rounded to be stored)
            w = wrapper()
            require(bits_equal(w if isinstance(w, torch.Tensor) else w[0],
                               launch(mode, False)[0]),
                    f"{name} {key}: the wrapper's call differs from the "
                    "launcher's")
            b_ms, b_by = loss_bound(name, t, v, es, mode)
            r = {"ms": time_ms(lambda: launch(mode, False), flush),
                 "plain_ms": time_ms(lambda: plain(mode, False), flush,
                                     iters=5, warmup=1),
                 "floor_ms": floor, "bound_ms": b_ms, "bound_by": b_by,
                 "max_abs_err": err}
            out.setdefault(name, {})[key] = r
            calls.append(lambda m=mode: launch(m, False))
            target = ""
            if fp32 and name in ("fused_distill_kl_grad",
                                 "fused_ce_distill_grad"):
                target = (f"; target <= {BWD_NARROW_TARGET_MS} ms "
                          + ("met" if r["ms"] <= BWD_NARROW_TARGET_MS
                             else "not met"))
            log(f"  bwd narrow {key}: {name} {r['ms']:.4f} ms  launch floor "
                f"{floor:.4f} ms ({r['ms'] / floor:.2f}x)  plain "
                f"{r['plain_ms']:.4f} ms  bound {b_ms:.3e} ms ({b_by}); "
                f"max|kernel-plain| {err:.2e}{target}")
        kt = step_kernels(lambda: [c() for c in calls])
        require(bool(kt), f"bwd narrow {label}: the profiler saw no device "
                "work")
        n_bwd = sum(n for n, k in kt if "bwd_kernel<" in k)
        n_all = sum(n for n, _k in kt)
        require(n_bwd == n_all == len(calls),
                f"bwd narrow {label}: {len(calls)} calls launched {n_bwd} "
                f"backward and {n_all} device kernels in all: "
                f"{[(n, k[:60]) for n, k in kt]}")
        log(f"  bwd narrow {label}: {len(calls)} calls, one kernel each "
            "(nothing else on the device; torch.profiler)")
        del x, tg, res, grads
    torch.cuda.empty_cache()
    return out


def step_kernels(fn) -> list:
    """[(calls, name)] of the device work (kernels, copies, memsets) of one
    call of ``fn``: torch.profiler's third step, after a wait and a warm-up
    step (a profile's first launches can go unrecorded)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1),
                 acc_events=True) as prof:
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return [(e.count, e.key) for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


def bits_digest(x: torch.Tensor) -> list:
    """Two wrapping int64 sums of ``x``'s bits, plain and weighted by
    position: equal tensors give equal digests (for outputs too large to
    keep)."""
    w = x.contiguous().view(torch.int16 if x.element_size() == 2
                            else torch.int32).reshape(-1)
    s0 = s1 = 0
    for c in w.split(1 << 24):
        c = c.long()
        pos = torch.arange(c.numel(), device=c.device) % 65521 + 1
        s0 += int(c.sum())
        s1 += int((c * pos).sum())
    return [s0, s1]


def phase_bwd_rows(dev: torch.device, dump: str) -> None:
    """Rows 7, 10, 11 and 13 (mse, kl) through their public wrappers at the
    main path's shape (BWD_MAIN) and at BWD_NARROW_SHAPES,
    from the kernel forwards' residual rows, the target's gradient skipped
    as on the paths: each ds (a digest of its bits at the main shape) and
    each call's time (``time_ms``) saved to ``dump``. Public API only, so
    the same phase runs on an older tree's package (``--src``)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    out, ms = {}, {}
    for si, (label, t, v, dtype) in enumerate([BWD_MAIN, *BWD_NARROW_SHAPES]):
        x, tg, lb, g = loss_inputs(t, v, dtype, dev, 500 + si)
        res = bwd_forward_rows(x, tg, lb)
        for name, mode, call in bwd_wrapper_calls(x, tg, lb, g, res, False):
            key = f"{name} {bwd_key(label, mode)}"
            ds = call()
            ds = ds if isinstance(ds, torch.Tensor) else ds[0]
            out[key] = bits_digest(ds) if t == TRAIN_T else ds.cpu()
            del ds
            ms[key] = time_ms(call, flush, iters=20 if t == TRAIN_T else 30)
        del x, tg, res
        torch.cuda.empty_cache()
    sync(dev)
    torch.save({"out": out, "ms": ms}, dump)
    log("bwd_rows: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))


# ----------------------------------------------------------------------------
# phase 4: full-width fleet
# ----------------------------------------------------------------------------

def serving_kernels(quantized: bool):
    return (("paged_attention_decode_quant", "paged_scatter_quant")
            if quantized else ("paged_attention_decode", "paged_scatter"))


def attn_sublayers(pool) -> int:
    """The attention sub-layers of a pool's model (its layers, for a
    dense model; one in each 8-layer step of jamba): the pool holds KV
    only for these, and the decode step launches rows 1-4 only there."""
    return len(pool.kv_subs) * pool.n_scan


def serve_launches(router, n_layers: int, k: int, fused: bool,
                   quantized: bool) -> dict:
    """Launches of rows 1-4 in one fleet run, ``n_layers`` attention
    sub-layers deep: a plain tick (a plain engine's, or a speculative
    engine's fallback) launches the decode and one K+V scatter per
    attention sub-layer; a speculative round launches k draft ticks and
    one verify: k + 1 decodes (the verify's over S*k pseudo-slots) and 2k
    scatters per attention sub-layer. The gather path gathers K and V (and
    their two scale pools) instead of each decode."""
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


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    """The gap between the largest and second-largest logit of each row."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def serve_run(model, peers, fc, wl, cache_dtype, dev, label, spec=None,
              margins=None):
    """One seeded fleet run through ``FleetRouter.run`` (round robin, or
    speculative with ``SpecConfig(k=spec)``), launch counts set to 0 just
    before and read just after, the wall time of each decode tick or
    speculative round on the side. Checks completion, nothing lost or
    duplicated, token ids in range and count, and rows 1-4's launches
    against the ticks and rounds. A plain run given a ``margins`` dict
    fills it with the top-2 logit margin behind each token, keyed (request
    id, token index): the prefill's for token 0, each tick's after.
    Returns (router, report, counts of rows 1-4, per-tick or per-round
    wall ms, wall s)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.fleet import (FleetEngine, FleetRouter,
                                         SpecConfig, SpecEngine)
    policy = "speculative" if spec else "round_robin"
    cls, name = (SpecEngine, "_spec_round") if spec else (FleetEngine,
                                                          "_decode_tick")
    orig, walls = getattr(cls, name), []
    orig_logits = FleetEngine.decode_logits

    def timed(self, *a):
        t0 = time.perf_counter()
        out = orig(self, *a)
        if out:                       # a tick with no live slot is not timed
            walls.append((time.perf_counter() - t0) * 1e3)
        return out

    def recorded(self, active, tokens):
        out = orig_logits(self, active, tokens)
        gap = top2_margin(out).cpu().numpy()
        for s, sl in self.slots.items():
            if active[s]:
                margins[(sl.record.request.rid, len(sl.record.tokens))] = \
                    float(gap[s])
        return out

    router = FleetRouter(model, peers, config=fc, policy=policy,
                         cache_dtype=cache_dtype, device=dev,
                         spec=SpecConfig(k=spec) if spec else None)
    record = margins is not None and not spec
    if record:
        for eng in router.engines:
            eng.keep_logits = True    # the prefill's logits, for token 0
    setattr(cls, name, timed)
    if record:
        FleetEngine.decode_logits = recorded
    try:
        sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = router.run(wl, slo_ms=50.0)
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        setattr(cls, name, orig)
        FleetEngine.decode_logits = orig_logits
    if record:
        for r in router._primaries:
            margins[(r.request.rid, 0)] = float(top2_margin(
                torch.from_numpy(r.prefill_logits)))
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
    want = serve_launches(router, attn_sublayers(router.engines[0].pool),
                          spec or 0, fc.fused_attention is not False,
                          quantized)
    require(counts == want, f"{label} {policy}: launches {counts} != "
            f"{want} (from the ticks and rounds)")
    return router, rep, counts, walls, wall


class routes_recorded:
    """Within the block, every MoE routing decision of the port
    (``models.moe._route``) appends (each token's set of chosen experts,
    sorted ids (G, T, k); router probs (G, T, E)) to the list the ``with``
    yields (on the host)."""

    def __enter__(self):
        import repro_torch.models.moe as moe_mod
        self.mod, self.orig, self.out = moe_mod, moe_mod._route, []

        def rec(m, logits, cap):
            r = self.orig(m, logits, cap)
            self.out.append((r[0].sort(-1).values.cpu(),
                             torch.softmax(logits, -1).cpu()))
            return r
        moe_mod._route = rec
        return self.out

    def __exit__(self, *exc):
        self.mod._route = self.orig
        return False


# the widest router margin (2nd - 3rd expert probability) at which the
# fused and gather ticks may route a slot to other experts: the two
# attention paths differ by bf16 rounding, which moves a probability by
# ~1e-3 (the flips on the card came at 7.9e-4 and 8.8e-4)
FLIP_MARGIN = 1e-2


def tick_check(model, peer, fc, wl, cache_dtype, dev: torch.device):
    """One engine with 16 live slots: a fused tick against a gather tick on
    the same pool (and the same recurrent states), launch counts of the
    gather tick, then the wall time of 5 fused ticks. Returns (engine,
    active, tokens, gather counts, ms per tick, the logits' tolerance: 5%
    of the fused tick's max|logits|)."""
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
    # a hybrid's recurrent states advance with each tick: the gather tick
    # starts from the states the fused tick started from
    states = {sub: {k: v.clone() for k, v in d.items()}
              for sub, d in eng.pool.states.items()}
    with routes_recorded() as fused_routes:
        fused = eng.decode_logits(active, tokens).float()
    fused_step, eng._decode = eng._decode, build_decode_step(
        model, fused_attention=False)
    eng.pool.states.update(states)
    reset_launch_counts()
    with routes_recorded() as oracle_routes:
        oracle = eng.decode_logits(active, tokens).float()
    sync(dev)
    oracle_counts = dict(launch_counts)
    eng._decode = fused_step
    # an MoE layer routes each slot by the top-2 of its router logits: a
    # rounding difference between the two attention paths can flip a
    # near-tie to another expert, a different function of that slot from
    # there on. The logits are held on the slots routed alike in every
    # layer; a flipped slot must flip where its router is within rounding
    # of a tie (2nd - 3rd probability under FLIP_MARGIN), and at least half
    # the slots must be routed alike
    same = torch.ones(S, dtype=torch.bool)
    flip_gaps = []
    for (ia, pa), (ib, _pb) in zip(fused_routes, oracle_routes):
        moved = (ia != ib).flatten(1).any(1)
        if bool((moved & same).any()):
            top = torch.topk(pa.flatten(1, -2), 3, dim=-1).values  # (S,T,3)
            gap = (top[..., 1] - top[..., 2]).amin(-1)
            flip_gaps += [float(gap[i]) for i in torch.nonzero(moved & same)]
        same &= ~moved
    scale = float(fused.abs().max())
    diff = float((fused - oracle)[same].abs().max()) if bool(same.any()) \
        else float("nan")
    agree = int((fused.argmax(-1) == oracle.argmax(-1)).sum())
    # bf16 activations round differently on the two attention paths (fp32
    # kernel state vs bf16 scores/weights of the oracle), and the difference
    # compounds over 28 layers: allow 5% of the logits' max magnitude
    log(f"fused vs gather tick {name}: max|dlogits| = {diff:.4f} over "
        f"{int(same.sum())}/{S} slots routed alike (max|logits| "
        f"{scale:.3f}, tol {0.05 * scale:.4f}), argmax agree {agree}/{S}"
        + (f"; {len(flip_gaps)} slots' experts flipped at router margins "
           f"(2nd - 3rd prob) {', '.join(f'{g:.2e}' for g in flip_gaps)}"
           if flip_gaps else "")
        + f", gather launches "
        f"{ {k: n for k, n in oracle_counts.items() if n} }")
    require(bool(torch.isfinite(fused).all() and torch.isfinite(oracle).all()),
            f"non-finite decode logits ({name})")
    require(2 * int(same.sum()) >= S,
            f"fused vs gather: only {int(same.sum())} of {S} slots routed "
            f"alike ({name})")
    require(all(g < FLIP_MARGIN for g in flip_gaps),
            f"fused vs gather: experts flipped at router margins "
            f"{flip_gaps}, not all under {FLIP_MARGIN} ({name})")
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
    return eng, active, tokens, oracle_counts, tick_ms, 0.05 * scale


def phase_fleet(dev: torch.device, cfg, smi_line: str):
    """qwen2-7b at full width, 2 peers, the seeded bursty workload over
    bf16 pools, then over int8 and fp8 pools; launch counts checked
    against the decode ticks of each run; a fused-vs-gather tick over each
    pool type, with its device profile."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.cost import step_cost
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
    eng, active, tokens, g_counts, tick_ms, _tol = tick_check(
        model, peers[0], fc, wl, torch.bfloat16, dev)
    require(g_counts["paged_gather"] == 2 * n_layers
            and g_counts["paged_scatter"] == n_layers
            and g_counts["paged_attention_decode"] == 0,
            f"gather tick launches {g_counts}")
    out["paged_gather"] = g_counts["paged_gather"]
    if dev.type == "cuda":
        busy = profile_ticks(eng, active, tokens, tick_ms)
        lengths = [int(x) for x in eng.pool.lengths]
        cost_check("fleet tick (qwen2-7b, 16 slots, bf16)", step_cost(
            replace(cfg, param_dtype="bfloat16"),
            InputShape("tick", fc.max_blocks_per_slot * fc.block_size, S,
                       "decode"), "decode",
            variant={"paged": {"lengths": lengths,
                               "num_blocks": fc.num_blocks,
                               "max_blocks": fc.max_blocks_per_slot}}),
            busy, lambda: eng.decode_logits(active, tokens), smi_line)
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
        eng, active, tokens, g_counts, tick_ms, _tol = tick_check(
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


def profile_ticks(eng, active, tokens, tick_ms: float, n: int = 3):
    """Device time of ``n`` decode ticks by kernel (torch.profiler) against
    their wall time: the device's busy share of a tick, and the decode
    attention's own device time in it. Returns the device ms a tick."""
    return profile_device(lambda: eng.decode_logits(active, tokens), tick_ms,
                          n, "tick", detail=("decode_", "scatter"))


def cost_check(what: str, cost, device_ms, fn, smi_line: str) -> None:
    """The cost model's per-step counts and bound (``launch/cost.py``: the
    larger of its FLOPs over 989 TFLOP/s bf16 or 67 fp32 and its bytes over
    3.35 TB/s, the H100 SXM's published peaks at 700 W) beside the
    measured device ms of that step, with the card's nvidia-smi line; then
    ``FlopCounterMode`` over one call of ``fn`` on the card, which sees the
    step's GEMMs (and no ctypes kernel launch): its count must equal the
    model's GEMM FLOPs within 1%."""
    from torch.utils.flop_counter import FlopCounterMode
    bound_ms = cost.bound_s * 1e3
    share = (f"{bound_ms / device_ms:.1%} of the {device_ms:.4f} ms device"
             if device_ms else "device time not measured")
    log(f"cost {what}: {cost.flops:.6e} FLOPs ({cost.gemm_flops:.6e} GEMM, "
        f"{cost.kernel_flops:.6e} kernels, {cost.other_flops:.6e} "
        f"elementwise), {cost.bytes:.6e} bytes; compute "
        f"{cost.compute_s * 1e3:.4f} ms, memory {cost.memory_s * 1e3:.4f} "
        f"ms: bound {bound_ms:.4f} ms ({cost.bound_by}; computed from the "
        f"H100 SXM's published peaks at 700 W), {share}; card: {smi_line}")
    with FlopCounterMode(display=False) as fcm:
        fn()
    sync(torch.device("cuda"))
    counted = fcm.get_total_flops()
    log(f"cost {what}: FlopCounterMode counted {counted:.6e} GEMM FLOPs "
        f"over one call on the card, the model {cost.gemm_flops:.6e} "
        f"(ratio {cost.gemm_flops / max(counted, 1):.5f})")
    require(counted > 0 and abs(cost.gemm_flops - counted) <= 0.01 * counted,
            f"{what}: the cost model's GEMM FLOPs {cost.gemm_flops:.6e} != "
            f"FlopCounterMode's {counted:.6e}")


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
# the depth of the spec phase's noised, int8, fp8 and gather-path runs (of
# 28): cut from 14, with the noised run moved from full depth, to make room
# for the rwkv phase in the script's time budget
SPEC_CUT_LAYERS = 7
# the identical bf16 runs and their verify: 14 of 28 layers (cut from 28
# for the shardmap phase)
SPEC_LAYERS = 14
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


def compare_streams(plain, spec, label: str, margins=None):
    """The share of the speculative run's tokens equal to the plain run's
    at the same place (each a router or a dict of streams by request). With the plain run's ``margins`` (``serve_run``),
    each request's first divergence is printed with the plain tick's top-2
    logit margin there, and their margins are returned beside the share
    (after a request's first divergence the two runs decode different
    contexts, so only that first token can tell rounding from a fault)."""
    a, b = (x if isinstance(x, dict) else
            {r.request.rid: r.tokens for r in x._primaries}
            for x in (plain, spec))
    same = n = 0
    firsts = []
    for rid in sorted(a):
        first = None
        for i, (x, y) in enumerate(zip(a[rid], b[rid])):
            n += 1
            same += int(x == y)
            if x != y and first is None:
                first = i
        if first is not None:
            firsts.append((rid, first))
    share = same / max(n, 1)
    log(f"  {label}: {same}/{n} tokens ({share:.1%}) equal to the plain "
        f"run's; {len(firsts)} of {len(a)} requests leave it"
        + ("" if firsts else ": none"))
    if margins is None:
        return share
    gaps = [margins[f] for f in firsts]
    if firsts:
        log(f"    first divergence (request, token, plain top-2 margin): "
            + ", ".join(f"({r}, {i}, {margins[(r, i)]:.4f})"
                        for r, i in firsts)
            + f"; margins there max {max(gaps):.4f}, median "
            f"{float(np.median(gaps)):.4f}; all tokens' median margin "
            f"{float(np.median(list(margins.values()))):.4f}")
    return share, gaps


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
    return max(diffs)


def phase_spec(dev: torch.device):
    """Peer-speculative decoding at qwen2-7b's full width and SPEC_LAYERS
    (14) of 28 layers, the fleet phase's FleetConfig and bursty workload, k = 4, ring pairing:
    identical peers (the same tensors twice) and a noised copy of peer 0,
    over bf16 pools (fused, and the gather path once) and int8 / fp8 pools,
    each run plain and speculative; then the exactness check in fp32 at a
    depth of 4 layers. Returns the speculative runs' launches of rows 1-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.fleet import FleetConfig, generate_workload
    cfg = replace(get_config("qwen2-7b"), num_layers=SPEC_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    p0 = model.init(gen, device=dev, weight_dtype=torch.bfloat16)
    sync(dev)
    log(f"spec: qwen2-7b {cfg.num_layers} layers in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    fc = FleetConfig(max_slots=16, block_size=16, num_blocks=1025,
                     max_blocks_per_slot=34, fused_attention=True)
    wl = generate_workload("bursty", 24, cfg.padded_vocab, seed=0,
                           max_prompt=512, max_new=32)
    # the noised, int8, fp8 and gather-path runs at SPEC_CUT_LAYERS of 28
    # (views of peer 0's first layers, and a noised copy of those): the
    # script's time budget
    cut = SPEC_CUT_LAYERS
    model_cut = build_model(replace(cfg, num_layers=cut))
    p_cut = {**p0, "layers": {sub: {g: {n: t[:cut] for n, t in d.items()}
                                    for g, d in sd.items()}
                              for sub, sd in p0["layers"].items()}}
    pn = noised_copy(p_cut, SPEC_NOISE, 99, dev)
    out = {}
    gather = replace(fc, fused_attention=False)
    runs = [("bf16 identical", model, [p0, p0], torch.bfloat16, fc),
            (f"bf16 noised ({cut} layers)", model_cut, [p_cut, pn],
             torch.bfloat16, fc),
            (f"int8 identical ({cut} layers)", model_cut, [p_cut, p_cut],
             torch.int8, fc),
            (f"fp8 identical ({cut} layers)", model_cut, [p_cut, p_cut],
             torch.float8_e4m3fn, fc),
            (f"bf16 identical gather ({cut} layers)", model_cut,
             [p_cut, p_cut], torch.bfloat16, gather)]
    # where each identical stream first leaves the plain one, and the plain
    # tick's top-2 margin there (ROADMAP Queue 3: fp8 streams leave most)
    diverged = {}
    for label, m, peers, dtype, f in runs:
        margins = {} if "identical" in label and f is fc else None
        plain, _rp, _c, ticks, _w = serve_run(m, peers, f, wl, dtype, dev,
                                              label, margins=margins)
        spec, rep, counts, rounds, _w = serve_run(m, peers, f, wl, dtype,
                                                  dev, label, spec=SPEC_K)
        if margins is None:
            compare_streams(plain, spec, label)
        else:
            diverged[dtype] = (label,) + compare_streams(plain, spec, label,
                                                         margins)
        log(f"  {label}: {np.mean(rounds):.2f} ms wall a speculative round "
            f"against {SPEC_K} plain ticks' {SPEC_K * np.mean(ticks):.2f} ms "
            f"({np.mean(rounds) / (SPEC_K * np.mean(ticks)):.2f}x); "
            f"{rep.generated_tokens / max(rep.spec_rounds, 1):.2f} tokens a "
            "round")
        for n, c in counts.items():
            out[n] = out.get(n, 0) + c
        del plain, spec
        torch.cuda.empty_cache()
    delta = {torch.bfloat16: verify_check(
        model, p0, fc, wl, torch.bfloat16, dev,
        f"verify bf16 bfloat16 pools ({cfg.num_layers} layers)", exact=False)}
    for cdt in QUANT:
        delta[cdt] = verify_check(
            model_cut, p_cut, fc, wl, cdt, dev,
            f"verify bf16 {str(cdt)[6:]} pools ({cut} layers)", exact=False)
    for cdt, (label, share, gaps) in diverged.items():
        inside = sum(g <= delta[cdt] for g in gaps)
        log(f"  divergence {label}: {share:.1%} of tokens equal; {inside} of "
            f"{len(gaps)} first divergences at a plain top-2 margin within "
            f"the verify's max|dlogits| {delta[cdt]:.4f} at its pool dtype"
            + (f" (the largest margin {max(gaps):.4f})" if gaps else ""))
    del p0, pn, p_cut
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
    """qwen1.5-0.5b at full width and PEERS_LAYERS (12) of 24 layers: the
    async runtime (2 peers,
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
    cfg = replace(get_config("qwen1.5-0.5b"), num_layers=PEERS_LAYERS)
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


def phase_train(dev: torch.device, smi_line: str):
    """qwen1.5-0.5b at full width and depth, fp32 master weights, bf16
    activations, through the training entry points ``train_codist`` and
    ``train_allreduce`` (weights from a seeded generator on the card): 2
    codistilling peers (mse, AdamW, cosine with warmup) for 10 steps at
    batch 8 x seq 512 per peer with a codist eval at steps 0 and 9, 2
    all-reduce steps and 2 codist steps with kl, launch counts checked per
    run; then the training CLI on the card (its reduced config)."""
    import contextlib
    import io

    from repro_torch.configs import (CodistConfig, InputShape, TrainConfig,
                                     get_config)
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.cost import step_cost
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
    busy = profile_device(lambda: bundle.apply(state, fixed, 10), step_ms, 2,
                          "step")
    # its bound: 2 peers x 8 x 512 tokens, fp32 masters, AdamW's fp32
    # moments, no remat (the TrainConfig's)
    cost_check("codist step (qwen1.5-0.5b, 2 peers x 8 x 512)", step_cost(
        cfg, InputShape("codist", s, 2 * b, "train"), "codist", 2,
        remat=tc.remat, variant={"optimizer": "adamw",
                                 "opt_dtype": tc.opt_dtype}),
        busy, lambda: bundle.apply(state, fixed, 11), smi_line)
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


# the train_peers and fleet_codist phases' depth (of 24): cut from 24 to
# make room for the shardmap phase in the script's time budget
PEERS_LAYERS = 12


def phase_train_peers(dev: torch.device):
    """qwen1.5-0.5b at full width and PEERS_LAYERS (12) of 24 layers, batch
    8 x seq 512 per peer, AdamW, through ``train_codist`` with the
    exchanges and wires beyond
    PR-12's two-peer prediction exchange. Each run's launches are counted
    from 0 and checked per distilling step; returns the summed launches."""
    from repro_torch.configs import CodistConfig, TrainConfig, get_config
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, resolve_strategy,
                                   stack_batches, train_codist)
    cfg = replace(get_config("qwen1.5-0.5b"), num_layers=PEERS_LAYERS)
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
# into the full config cut to SWEEP_LAYERS of its 24 layers (the phase
# requires the two equal); the cut from 24 makes room for the shardmap
# phase in the script's time budget
SWEEP_LAYERS = 12
FULL_OVERRIDES = {"num_layers": SWEEP_LAYERS, "d_model": 1024, "num_heads": 16,
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
# the async and obs phases' depth (of 24): cut from 12 to make room for
# the rwkv phase in the script's time budget (most of the async phase is
# its 6 snapshots of a peer's state, which scale with the depth)
ASYNC_LAYERS = 6
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
    full = replace(get_config(arch), num_layers=SWEEP_LAYERS)
    require(replace(get_reduced(arch), **FULL_OVERRIDES) == full,
            "the sweep's model_overrides do not restore get_config at "
            f"{SWEEP_LAYERS} layers")
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
            f"full width, {SWEEP_LAYERS} of 24 layers, batch 8 x seq 512 a "
            f"peer, {SWEEP_STEPS} steps):")
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
    """The async runtime at qwen1.5-0.5b's full width and 6 of its 24
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
    # full width at ASYNC_LAYERS (6) of its 24 layers: the depth cut keeps
    # the whole script within its time budget since the spec, fleet_codist
    # and rwkv phases came in (a snapshot of the peer state, fp32 params +
    # AdamW m and v, is host I/O of ~2.8 GB instead of 5.6 at full depth)
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

# ----------------------------------------------------------------------------
# phase 14: dense serving (Engine.generate, LM.decode; ``--single``)
# ----------------------------------------------------------------------------

# the dense engine's batches: prompts of SINGLE_PROMPT tokens, SINGLE_NEW new
# ones (the CLI's defaults), at batch 4 (the CLI's) and 16 (the fleet's slots)
SINGLE_BATCHES, SINGLE_PROMPT, SINGLE_NEW = (4, 16), 64, 16
# the ring-buffer check: a window shorter than the prompt, so the ring wraps
SINGLE_WINDOW = 48


def single_timings(model, params, eng, b: int, dev: torch.device) -> dict:
    """At batch ``b`` of seeded prompts: prefill ms (wall), ms a decode step
    (wall, the 15 steps after a prefill, argmax between), the device's busy
    share of a step (torch.profiler over 5 more steps), and tokens/s of
    ``Engine.generate`` (prefill included); two generate calls must give
    equal tokens."""
    cfg = model.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(2100 + b)
    toks = torch.randint(0, cfg.padded_vocab, (b, SINGLE_PROMPT),
                         generator=gen, device=dev)
    eng.generate({"tokens": toks}, 2)                          # warm-up
    cap = SINGLE_PROMPT + SINGLE_NEW + 5
    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, toks, cap, torch.bfloat16)
        sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pos = [SINGLE_PROMPT]

        def step():
            nonlocal logits, cache
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = model.decode(params, cache, tok, pos[0])
            pos[0] += 1

        t0 = time.perf_counter()
        for _ in range(SINGLE_NEW - 1):
            step()
        sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / (SINGLE_NEW - 1)
        log(f"  batch {b}: prefill of {SINGLE_PROMPT} tokens {prefill_ms:.2f} "
            f"ms wall, decode {step_ms:.2f} ms wall a step")
        busy = profile_device(step, step_ms, 5, "decode step")
    sync(dev)
    t0 = time.perf_counter()
    r1 = eng.generate({"tokens": toks}, SINGLE_NEW)
    sync(dev)
    wall = time.perf_counter() - t0
    r2 = eng.generate({"tokens": toks}, SINGLE_NEW)
    require(torch.equal(r1.tokens, r2.tokens),
            f"single batch {b}: two generate calls differ")
    new = r1.tokens[:, SINGLE_PROMPT:]
    require(tuple(r1.tokens.shape) == (b, SINGLE_PROMPT + SINGLE_NEW)
            and bool(((new >= 0) & (new < cfg.padded_vocab)).all()),
            f"single batch {b}: tokens of shape {tuple(r1.tokens.shape)} or "
            "out of range")
    tps = b * SINGLE_NEW / wall
    log(f"  batch {b}: Engine.generate {b} x {SINGLE_NEW} tokens in "
        f"{wall * 1e3:.1f} ms wall, {tps:.1f} tokens/s (prefill included); "
        "two calls equal")
    return {"prefill_ms": prefill_ms, "step_ms": step_ms, "busy_ms": busy,
            "tokens_per_s": tps}


def phase_single(dev: torch.device):
    """Dense serving on the card: ``Engine.generate`` at qwen2-7b's full
    width and depth (28 layers, d 3584, 28 / 4 heads, hd 128, V 152064;
    seeded bf16 weights, a bf16 cache) at batch 4 and 16, prompts of 64, 16
    new tokens: times (``single_timings``), two calls equal, no launch of
    rows 1-4. Then in fp32 (TF32 off since the device phase) at full width
    and 4 of 28 layers (cut for time and memory): ragged equals
    per-request; with a 48-token window and 64-token prompts (the ring
    wraps) the decode's logits equal the windowed teacher forcing within
    5e-4; and at the reduced config the card's tokens equal the port's on
    the CPU (same weights), uniform and ragged. Last, ``--single`` through
    the CLI on the card."""
    import contextlib
    import io
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import build_model
    from repro_torch.serve import Engine
    from repro_torch.tree import tree_map
    cfg = get_config("qwen2-7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    params = model.init(gen, device=dev, weight_dtype=torch.bfloat16)
    sync(dev)
    log(f"single: qwen2-7b {cfg.num_layers} layers in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    eng = Engine(model, params, cache_dtype=torch.bfloat16, device=dev)
    reset_launch_counts()
    for b in SINGLE_BATCHES:
        single_timings(model, params, eng, b, dev)
    launched = {k: n for k, n in launch_counts.items() if n}
    require(not launched, f"single: the dense path launched {launched}")
    log("single: no kernel of rows 1-14 launched (dense attention is "
        "torch.matmul)")
    del eng, params
    torch.cuda.empty_cache()

    # fp32 at 4 layers: ragged == per-request, the ring buffer
    cfg4 = replace(cfg, num_layers=4, dtype="float32")
    model4 = build_model(cfg4)
    gen.manual_seed(2025)
    p4 = model4.init(gen, device=dev, weight_dtype=torch.float32)
    eng4 = Engine(model4, p4, cache_dtype=torch.float32, device=dev)
    lens = [SINGLE_PROMPT, 17, 40, 33]
    toks = torch.randint(0, cfg.padded_vocab, (len(lens), SINGLE_PROMPT),
                         generator=gen, device=dev)
    ragged = eng4.generate({"tokens": toks}, SINGLE_NEW, prompt_lens=lens)
    for r, n in enumerate(lens):
        one = eng4.generate({"tokens": toks[r:r + 1, :n]}, SINGLE_NEW)
        require(torch.equal(ragged.tokens[r, SINGLE_PROMPT:],
                            one.tokens[0, n:]),
                f"single fp32: ragged row {r} (len {n}) != per-request")
    log(f"single fp32 4 layers: ragged (lens {lens}) equals per-request")
    modelw = build_model(replace(cfg4, sliding_window=SINGLE_WINDOW))
    seq = torch.randint(0, cfg.padded_vocab, (2, SINGLE_PROMPT + SINGLE_NEW),
                        generator=gen, device=dev)
    worst = 0.0
    with torch.no_grad():
        full, _ = modelw.forward(p4, {"tokens": seq})
        logits, cache = modelw.prefill(p4, seq[:, :SINGLE_PROMPT],
                                       SINGLE_PROMPT + SINGLE_NEW,
                                       torch.float32)
        require(cache["sub0"]["k"].shape[2] == SINGLE_WINDOW,
                "single: the windowed cache is not a ring of the window")
        for i in range(SINGLE_PROMPT, SINGLE_PROMPT + SINGLE_NEW):
            want = full[:, i - 1]
            err = (logits[:, 0] - want).abs()
            worst = max(worst, float(err.max()))
            require(bool((err <= 5e-4 + 5e-4 * want.abs()).all()),
                    f"single ring buffer: position {i - 1} beyond 5e-4 "
                    f"(max {float(err.max()):.3e})")
            logits, cache = modelw.decode(p4, cache, seq[:, i:i + 1], i)
    log(f"single fp32 4 layers, window {SINGLE_WINDOW}, prompts of "
        f"{SINGLE_PROMPT}: decode logits within {worst:.3e} of the windowed "
        "teacher forcing (tol 5e-4)")
    del eng4, p4, full, cache
    torch.cuda.empty_cache()

    # the card's tokens against the CPU's at the reduced config (fp32)
    red = get_reduced("qwen2-7b")
    modelr = build_model(red)
    gcpu = torch.Generator()
    gcpu.manual_seed(2026)
    pr = modelr.init(gcpu, device="cpu", weight_dtype=torch.float32)
    toks = torch.randint(0, red.padded_vocab, (4, 12), generator=gcpu)
    lens = [12, 5, 9, 7]
    outs = {}
    for d in ("cpu", dev):
        e = Engine(modelr, tree_map(lambda x: x.to(d), pr),
                   cache_dtype=torch.float32, device=d)
        outs[str(d)] = (e.generate({"tokens": toks.to(d)}, 8).tokens.cpu(),
                        e.generate({"tokens": toks.to(d)}, 8,
                                   prompt_lens=lens).tokens.cpu())
    for name, a, b in zip(("uniform", "ragged"), outs["cpu"], outs[str(dev)]):
        require(torch.equal(a, b), f"single reduced {name}: card tokens != "
                "CPU tokens")
    log("single reduced qwen2-7b fp32: card tokens equal the CPU's, uniform "
        "and ragged")

    # the CLI on the card
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_main(["--single", "--arch", "qwen2-7b"])
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  cli: {line}")
    require(len(lines) == 3 and lines[0].startswith("arch=qwen2-7b batch=4")
            and lines[2].startswith("first sequence: ["),
            f"single: --single printed {lines}")
    single_other_archs(dev)


# the archs beside qwen2-7b that --single serves, at full width: the depth
# each is cut to (None: full depth). internvl2-76b takes 8 of 80 layers
# (~0.86 B parameters a layer and two 128256 x 8192 vocab matrices: ~18 GB
# of bf16 weights), with its 256 patch embeddings before the prompt
SINGLE_ARCHS = {"transformer-big": None, "whisper-tiny": None,
                "internvl2-76b": 8}


def single_batch(cfg, b: int, prompt: int, gen, dev) -> dict:
    """``Engine.generate``'s batch for ``cfg``: b seeded prompts and the
    stub frontend's input, 0.1-scaled normal patch embeddings (VLM) or
    encoder frames, or source tokens (an enc-dec model without frames)."""
    batch = {"tokens": torch.randint(0, cfg.padded_vocab, (b, prompt),
                                     generator=gen, device=dev)}
    if cfg.num_patches:
        batch["patches"] = 0.1 * torch.randn(
            (b, cfg.num_patches, cfg.d_model), generator=gen, device=dev)
    if cfg.is_encdec and cfg.num_audio_frames:
        batch["frames"] = 0.1 * torch.randn(
            (b, cfg.num_audio_frames, cfg.d_model), generator=gen, device=dev)
    elif cfg.is_encdec:
        batch["src_tokens"] = torch.randint(0, cfg.padded_vocab, (b, prompt),
                                            generator=gen, device=dev)
    return batch


def single_arch(arch: str, layers, dev: torch.device) -> dict:
    """``arch`` at full width (``layers`` of its depth, None: all) through
    Engine.generate: seeded bf16 weights and cache, batch 4, prompts of
    SINGLE_PROMPT tokens after the patch prefix or beside the encoder's
    input (``single_batch``), 16 new: prefill ms, ms a decode step (wall)
    and the busy share (torch.profiler), two calls equal, tokens in range,
    no kernel launched (dense attention is torch.matmul)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serve import Engine
    full = get_config(arch)
    cfg = full if layers is None else replace(full, num_layers=layers)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    params = model.init(gen, device=dev, weight_dtype=torch.bfloat16)
    b = 4
    batch = single_batch(cfg, b, SINGLE_PROMPT, gen, dev)
    prefix = cfg.num_patches if "patches" in batch else 0
    sync(dev)
    inputs = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    log(f"single {arch}: {cfg.num_layers} of {full.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers" if cfg.is_encdec else "")
        + f" (d {cfg.d_model}, V {cfg.padded_vocab}) in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; "
        f"{inputs}")
    eng = Engine(model, params, cache_dtype=torch.bfloat16, device=dev)
    reset_launch_counts()
    eng.generate(batch, 2)                                     # warm-up
    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(
            params, batch, prefix + SINGLE_PROMPT + SINGLE_NEW + 5,
            torch.bfloat16)
        sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pos = [prefix + SINGLE_PROMPT]

        def step():
            nonlocal logits, cache
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = model.decode(params, cache, tok, pos[0])
            pos[0] += 1

        t0 = time.perf_counter()
        for _ in range(SINGLE_NEW - 1):
            step()
        sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / (SINGLE_NEW - 1)
        busy = profile_device(step, step_ms, 5, "decode step")
    sync(dev)
    t0 = time.perf_counter()
    r1 = eng.generate(batch, SINGLE_NEW)
    sync(dev)
    wall = time.perf_counter() - t0
    r2 = eng.generate(batch, SINGLE_NEW)
    new = r1.tokens[:, SINGLE_PROMPT:]
    require(torch.equal(r1.tokens, r2.tokens),
            f"single {arch}: two generate calls differ")
    require(tuple(r1.tokens.shape) == (b, SINGLE_PROMPT + SINGLE_NEW)
            and bool(((new >= 0) & (new < cfg.padded_vocab)).all()),
            f"single {arch}: tokens of shape {tuple(r1.tokens.shape)} or "
            "out of range")
    launched = {k: n for k, n in launch_counts.items() if n}
    require(not launched, f"single {arch} launched {launched}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"single {arch} batch {b}: prefill of {prefix} + {SINGLE_PROMPT} "
        f"tokens {prefill_ms:.2f} ms wall, decode {step_ms:.2f} ms wall a "
        "step, busy "
        + (f"{busy:.2f} ms ({busy / step_ms:.1%})" if busy else
           "not measured")
        + f"; Engine.generate {b} x {SINGLE_NEW} tokens in {wall * 1e3:.1f} "
        f"ms wall ({b * SINGLE_NEW / wall:.1f} tokens/s); two calls equal; "
        f"no kernel launched; peak {peak:.2f} GiB")
    del eng, params, cache
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "step_ms": step_ms, "busy_ms": busy,
            "peak_gib": peak}


def single_other_archs(dev: torch.device) -> None:
    """The archs of SINGLE_ARCHS through Engine.generate (``single_arch``;
    transformer-big's full config reads source tokens, whisper-tiny reads
    1500 frames, internvl2 256 patches), the reduced configs card against
    CPU (``single_parity``), then ``--single --arch`` each (the reduced
    config, seeded frames or patches) through the CLI on the card."""
    import contextlib
    import io
    from repro_torch.launch.serve import main as serve_main
    for arch, layers in SINGLE_ARCHS.items():
        single_arch(arch, layers, dev)
    single_parity(dev)
    for arch in SINGLE_ARCHS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_main(["--single", "--arch", arch])
        lines = buf.getvalue().strip().splitlines()
        for line in lines:
            log(f"  cli: {line}")
        require(len(lines) == 3
                and lines[0].startswith(f"arch={arch} batch=4")
                and lines[2].startswith("first sequence: ["),
                f"single: --single --arch {arch} printed {lines}")


# the reduced configs held card against CPU: (arch, config overrides)
PARITY_SOURCES = [("transformer-big", {}),            # frames
                  ("transformer-big", {"num_audio_frames": 0}),
                  ("whisper-tiny", {}), ("internvl2-76b", {})]


def single_parity(dev: torch.device) -> None:
    """The reduced configs of PARITY_SOURCES in fp32 (TF32 off since the
    device phase), the card against the CPU from the same weights and
    inputs: Engine.generate's tokens equal over encoder ``frames``, over
    ``src_tokens`` and after a ``patches`` prefix."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.serve import Engine
    from repro_torch.tree import tree_map
    for arch, over in PARITY_SOURCES:
        model = build_model(replace(get_reduced(arch), **over))
        gen = torch.Generator()
        gen.manual_seed(33)
        params = model.init(gen, device="cpu", weight_dtype=torch.float32)
        batch = single_batch(model.cfg, 4, 12, gen, "cpu")
        outs = []
        for d in ("cpu", dev):
            e = Engine(model, tree_map(lambda x: x.to(d), params),
                       cache_dtype=torch.float32, device=d)
            outs.append(e.generate({k: v.to(d) for k, v in batch.items()},
                                   8).tokens.cpu())
        require(torch.equal(outs[0], outs[1]),
                f"single reduced {arch} over {sorted(batch)}: card tokens "
                "!= CPU tokens")
        log(f"single reduced {arch} fp32 over {sorted(batch)}: "
            "Engine.generate tokens equal card vs CPU")


# ----------------------------------------------------------------------------
# phase 15: the observability layer (tracer, metrics, Watchtower, recorder)
# ----------------------------------------------------------------------------

# the obs phase's chaos: peer 1 straggles 4x over 30% of its ticks, peer 0
# is preempted for 120 simulated ms after its tick 6; defended, hedging
OBS_FAULTS = "straggler=1*4@0.3,preempt=0@6+120"
# the async runtime's faults without the elastic join, and the failed peer
# stays dead: no snapshot or restore (the async phase times those)
OBS_ASYNC_STEPS = 5
OBS_SWEEP_STEPS = 3
# obs off and on in turns, after a warm-up run
OBS_ORDER = ("off", "on", "on", "off", "off", "on")
# (a)'s depth: 14 of 28 layers (cut from 28 for the shardmap phase)
OBS_LAYERS = 14


def trace_checked(paths) -> None:
    """``tools/trace_check.py`` over obs files (it imports nothing of the
    JAX package); its per-file lines go to the log."""
    import contextlib
    import io
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import trace_check
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = trace_check.main(list(paths))
    require(rc == 0, f"trace_check failed: {out.getvalue()}")
    log(f"  trace_check: {len(paths)} files OK")


def obs_files(out_dir: str) -> dict:
    """{relative path: text} of every file an obs run wrote."""
    out = {}
    for base, _dirs, names in os.walk(out_dir):
        for name in names:
            path = os.path.join(base, name)
            with open(path) as f:
                out[os.path.relpath(path, out_dir)] = f.read()
    return out


def obs_fleet_run(model, peers, fc, wl, dev, out_dir=None) -> dict:
    """One seeded, defended chaos run (``OBS_FAULTS``, hedging) through
    ``FleetRouter.run``; with ``out_dir`` a tracer, a registry, the default
    rules and a flight recorder ride along and their files are written
    there, and the host time inside the per-tick hooks is taken (the
    engine's trace and metrics hooks and the Watchtower's evaluation, less
    the bundle dumps, which are timed on their own). Launch counts are set to 0 just before the run
    and read just after. Returns the report, the counts of rows 1-4, the
    run's wall s, its engine ticks, the files, the seconds in each hook and
    those spent in bundle dumps and in saving the other files."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import (FlightRecorder, MetricsRegistry, Watchtower,
                                 default_rules, for_sim_ms)
    from repro_torch.runtime import parse_faults
    from repro_torch.serve.fleet import (ChaosConfig, FleetDefense,
                                         FleetEngine, FleetRouter)
    kw, dump_s = {}, [0.0]
    hook_s = dict.fromkeys(("trace", "metrics", "watch"), 0.0)

    def timed(key, fn):
        def wrapped(*a, **k):
            t0, d0 = time.perf_counter(), dump_s[0]
            try:
                return fn(*a, **k)
            finally:
                hook_s[key] += time.perf_counter() - t0 - (dump_s[0] - d0)
        return wrapped
    hooks = {"_trace_tick": FleetEngine._trace_tick,
             "_record_tick": FleetEngine._record_tick}
    if out_dir is not None:
        tracer, metrics = for_sim_ms(), MetricsRegistry()
        watch = Watchtower(metrics, default_rules(slo_ms=50.0),
                           unit_us=1000.0, clock="sim_ms")
        recorder = FlightRecorder(os.path.join(out_dir, "postmortem"),
                                  metrics=metrics)
        dump = recorder.dump

        def timed_dump(*a, **k):     # a file write and an fsync each
            t0 = time.perf_counter()
            path = dump(*a, **k)
            dump_s[0] += time.perf_counter() - t0
            return path
        recorder.dump = timed_dump
        tracer.recorder = recorder
        watch.on_alert(recorder.on_alert)
        watch.on_fault(recorder.on_fault)
        watch.evaluate = timed("watch", watch.evaluate)
        kw = dict(tracer=tracer, metrics=metrics, watch=watch)
    router = FleetRouter(
        model, peers, config=fc, device=dev,
        chaos=ChaosConfig(parse_faults(OBS_FAULTS, len(peers), seed=0)),
        defense=FleetDefense(hedging=True, hedge_min_samples=3), **kw)
    FleetEngine._trace_tick = timed("trace", hooks["_trace_tick"])
    FleetEngine._record_tick = timed("metrics", hooks["_record_tick"])
    try:
        sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = router.run(wl, slo_ms=50.0)
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        for name, fn in hooks.items():
            setattr(FleetEngine, name, fn)
    counts = {k: launch_counts[k] for k in ROWS_1_TO_4}
    save_s = 0.0
    if out_dir is not None:
        t0 = time.perf_counter()
        tracer.save(os.path.join(out_dir, "trace.json"))
        metrics.save(os.path.join(out_dir, "metrics.json"))
        watch.save(os.path.join(out_dir, "alerts.jsonl"))
        save_s = time.perf_counter() - t0
    return {"report": rep.to_dict(), "counts": counts, "wall": wall,
            "ticks": sum(e.steps for e in router.engines),
            "files": obs_files(out_dir) if out_dir else {},
            "hook_s": hook_s, "dump_s": dump_s[0], "save_s": save_s}


def spread(xs) -> str:
    return (f"median {np.median(xs):.2f}, min {min(xs):.2f}, max "
            f"{max(xs):.2f} ({', '.join(f'{x:.2f}' for x in xs)})")


def phase_obs(dev: torch.device, smi_line: str):
    """The observability layer on the card. (a) qwen2-7b at full width and
    OBS_LAYERS (14) of 28 layers, seeded bf16 weights, 2 peers, the fleet
    phase's FleetConfig and bursty workload under ``OBS_FAULTS``, defended with hedging: after a
    warm-up run, obs-off and obs-on runs in turns (``OBS_ORDER``), each
    on-run with a tracer, a registry, the default rules and a flight
    recorder; the files pass trace_check, the on-runs write byte-identical
    files, every run's ``FleetReport`` and launch counts equal; wall a tick
    with obs on and off, and the host time inside the hooks a tick. (b) The same scenario at the reduced config in fp32 on the
    card and on the CPU: byte-equal trace and alert log. (c) ``codist-async``
    at qwen1.5-0.5b's full width and ``ASYNC_LAYERS`` layers, kl, under
    ``ASYNC_FAULTS`` (the failed peer not recovered) with tracer, registry,
    rules and flight recorder: the files pass trace_check. (d) A 2-cell sweep (all-reduce and codist,
    ``OBS_SWEEP_STEPS`` steps at full width) through the sweep CLI with
    ``--trace --metrics --alerts``: every file passes trace_check. Returns
    the launches of (a)'s on-runs, (c) and (d)."""
    import contextlib
    import io
    import tempfile

    import yaml

    from repro_torch.configs import (CodistConfig, TrainConfig, get_config,
                                     get_reduced)
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import sweep as sweep_cli
    from repro_torch.models import build_model
    from repro_torch.obs import (FlightRecorder, MetricsRegistry, Watchtower,
                                 default_rules, for_sim_seconds)
    from repro_torch.runtime import AsyncScheduler, parse_faults
    from repro_torch.serve.fleet import FleetConfig, generate_workload
    launches = dict.fromkeys(SOURCES, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # ---- (a) the chaos fleet at full width, OBS_LAYERS of 28 ----
    cfg = replace(get_config("qwen2-7b"), num_layers=OBS_LAYERS)
    model = build_model(cfg)
    peers = []
    for i in range(2):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1234 + i)
        peers.append(model.init(gen, device=dev, weight_dtype=torch.bfloat16))
    fc = FleetConfig(max_slots=16, block_size=16, num_blocks=1025,
                     max_blocks_per_slot=34, fused_attention=True)
    wl = generate_workload("bursty", 24, cfg.padded_vocab, seed=0,
                           max_prompt=512, max_new=32)
    runs = {"off": [], "on": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, kind in enumerate(("warm-up",) + OBS_ORDER):
            out_dir = os.path.join(tmp, f"run{i}") if kind == "on" else None
            r = obs_fleet_run(model, peers, fc, wl, dev, out_dir)
            runs.setdefault(kind, []).append(r)
            rep = r["report"]
            log(f"  obs {kind} run {i}: {r['ticks']} ticks in {r['wall']:.2f} "
                f"s wall = {r['wall'] / r['ticks'] * 1e3:.2f} ms a tick; "
                f"completed {rep['completed']}, migrations "
                f"{rep['migrations']}, hedges {rep['hedges']}, preemptions "
                f"{rep['preemptions']}, lost {rep['lost_tokens']}, "
                f"duplicated {rep['duplicated_tokens']}"
                + (f"; {len(r['files'])} files, hooks (no dumps) "
                   + ", ".join(f"{k} {v * 1e3:.2f}"
                               for k, v in r["hook_s"].items())
                   + f" ms, bundle dumps {r['dump_s'] * 1e3:.1f} ms, saves "
                   f"{r['save_s'] * 1e3:.1f} ms" if kind == "on" else ""))
        on, off = runs["on"], runs["off"]
        first = on[0]
        trace_checked([os.path.join(tmp, f"run{OBS_ORDER.index('on') + 1}",
                                    name) for name in sorted(first["files"])])
    for r in on + off + runs["warm-up"]:
        require(r["report"] == first["report"],
                "obs: a run's FleetReport differs from the first on-run's")
        require(r["counts"] == first["counts"],
                f"obs: launches {r['counts']} != {first['counts']}")
    for r in on[1:]:
        require(r["files"] == first["files"],
                "obs: two seeded on-runs wrote different files: " + ", ".join(
                    n for n in first["files"]
                    if r["files"].get(n) != first["files"][n]))
    rep = first["report"]
    require(rep["completed"] == len(wl.requests) and rep["lost_tokens"] == 0
            and rep["duplicated_tokens"] == 0 and rep["preemptions"] >= 1,
            f"obs chaos run: {rep}")
    alerts = [json.loads(line) for line in
              first["files"]["alerts.jsonl"].splitlines()[1:]]
    bundles = sorted(n for n in first["files"] if n.startswith("postmortem"))
    require(any(n.endswith("fault-preempt.json") for n in bundles),
            f"obs: no preemption bundle in {bundles}")
    tick = {k: [r["wall"] / r["ticks"] * 1e3 for r in runs[k]]
            for k in ("on", "off")}
    hook_ms = [sum(r["hook_s"].values()) / r["ticks"] * 1e3 for r in on]
    dump_ms = [r["dump_s"] / r["ticks"] * 1e3 for r in on]
    log(f"obs chaos fleet (qwen2-7b {cfg.num_layers} layers, bf16, 2 peers, "
        f"{len(wl.requests)} bursty requests, {OBS_FAULTS}, hedging): "
        f"report and launches equal in all {len(OBS_ORDER) + 1} runs "
        f"({ {k: n for k, n in first['counts'].items() if n} }); "
        f"{len(alerts)} alert events "
        f"({sorted({a['rule'] + ':' + a['state'] for a in alerts})}), "
        f"{len(bundles)} bundles, files byte-identical in {len(on)} seeded "
        "runs")
    log(f"obs wall a tick [{smi_line}]: on {spread(tick['on'])} ms, off "
        f"{spread(tick['off'])} ms; median on / off "
        f"{np.median(tick['on']) / np.median(tick['off']):.4f}; host time "
        f"in the hooks {spread(hook_ms)} ms a tick, bundle dumps "
        f"{spread(dump_ms)} ms a tick (together "
        f"{(np.median(hook_ms) + np.median(dump_ms)) / np.median(tick['off']):.2%}"
        f" of the off tick's median); bundle dumps "
        f"{spread([r['dump_s'] * 1e3 for r in on])} ms a run")
    add(first["counts"])
    del peers, model
    torch.cuda.empty_cache()

    # ---- (b) fp32 (TF32 off): the card's trace and alerts against the CPU's
    cfg = get_reduced("qwen2-7b")
    model = build_model(cfg)
    cpu_peers = []
    for i in range(2):
        gen = torch.Generator()
        gen.manual_seed(77 + i)
        cpu_peers.append(model.init(gen, device="cpu"))
    to_dev = lambda tree: ({k: to_dev(v) for k, v in tree.items()}  # noqa: E731
                           if isinstance(tree, dict) else tree.to(dev))
    small = FleetConfig(max_slots=3, block_size=4, num_blocks=64,
                        max_blocks_per_slot=16, max_prefills_per_step=1)
    swl = generate_workload("bursty", 12, cfg.padded_vocab, seed=4,
                            max_prompt=40, max_new=12)
    with tempfile.TemporaryDirectory() as tmp:
        res = {d: obs_fleet_run(model, p, small, swl, torch.device(d_),
                                os.path.join(tmp, d))
               for d, p, d_ in (("cpu", cpu_peers, "cpu"),
                                ("card", [to_dev(p) for p in cpu_peers],
                                 dev.type))}
    a, b = res["cpu"], res["card"]
    same = sorted(n for n in a["files"] if b["files"].get(n) == a["files"][n])
    log(f"  obs fp32 parity (reduced qwen2-7b): card vs CPU files equal: "
        f"{same} of {sorted(a['files'])}; migrations "
        f"{b['report']['migrations']}, hedges {b['report']['hedges']}")
    require(a["report"] == b["report"], "obs fp32: reports differ")
    for name in ("trace.json", "alerts.jsonl"):
        require(a["files"][name] == b["files"][name],
                f"obs fp32: {name} differs card vs CPU")

    # ---- (c) the async runtime with its faults ----
    cfg = replace(get_config("qwen1.5-0.5b"), num_layers=ASYNC_LAYERS)
    model = build_model(cfg)
    task = MarkovLM(vocab=min(cfg.vocab_size, 512), seed=0,
                    effective_vocab=256)

    def batches(step):
        return make_lm_batch(task, TRAIN_T // 512, 512, step, None, seed=0,
                             device=dev)
    tc = TrainConfig(lr=1e-3, lr_schedule="cosine", warmup_steps=2,
                     total_steps=OBS_ASYNC_STEPS, optimizer="adamw")
    with tempfile.TemporaryDirectory() as tmp:
        tracer, metrics = for_sim_seconds(), MetricsRegistry()
        watch = Watchtower(metrics, default_rules(), unit_us=1_000_000.0,
                           clock="sim_s")
        recorder = FlightRecorder(os.path.join(tmp, "postmortem"),
                                  metrics=metrics)
        tracer.recorder = recorder
        watch.on_alert(recorder.on_alert)
        watch.on_fault(recorder.on_fault)
        sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        report = AsyncScheduler(
            model, tc, CodistConfig(n_models=2, distill_loss="kl"), batches,
            parse_faults(ASYNC_FAULTS, 2), staleness_bound=1, device=dev,
            tracer=tracer, metrics=metrics, watch=watch).run()
        sync(dev)
        wall = time.perf_counter() - t0
        counts = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
        paths = [os.path.join(tmp, n) for n in ("trace.json", "metrics.json",
                                                "alerts.jsonl")]
        tracer.save(paths[0])
        metrics.save(paths[1])
        watch.save(paths[2])
        trace_checked(paths + recorder.dumped)
        names = {e["name"] for e in tracer.to_dict()["traceEvents"]}
    log(f"  obs async (qwen1.5-0.5b {ASYNC_LAYERS} layers, kl, "
        f"{ASYNC_FAULTS}): {wall:.1f} s wall, sim_time {report.sim_time}, "
        f"{tracer.n_events} trace events, alerts {watch.summary()}, "
        f"{len(recorder.dumped)} bundles; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    require({"step", "publish", "die", "preempted"} <= names,
            f"obs async: trace events {sorted(names)}")
    require(any(p.endswith("fault-fail.json") for p in recorder.dumped),
            f"obs async: bundles {recorder.dumped}")
    for k in ("fused_cross_entropy_parts", "fused_cross_entropy_grad",
              "fused_distill_kl_parts", "fused_distill_kl_grad"):
        require(counts[k] > 0, f"obs async: {k} never launched")
    add(counts)
    del model, report
    torch.cuda.empty_cache()

    # ---- (d) a 2-cell sweep through the CLI with every obs flag ----
    doc = {"name": "obs_sweep", "arch": "qwen1.5-0.5b", "seq_len": 512,
           "steps": OBS_SWEEP_STEPS, "optimizer": "adamw",
           "distill_loss": "mse", "seeds": [0],
           "batch_sizes": [TRAIN_T // 512],
           "lr_schedules": [{"name": "cos1e3", "kind": "cosine", "lr": 1e-3,
                             "warmup_frac": 0.1}],
           "modes": ["allreduce", "codist"],
           "alpha_schedules": [{"name": "const", "alpha0": 1.0}],
           "peers": [2], "model_overrides": FULL_OVERRIDES}
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, "obs_sweep.yaml")
        with open(spec_path, "w") as f:
            yaml.safe_dump(doc, f)
        out = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = sweep_cli.main(["--spec", spec_path, "--out", tmp,
                                 "--device", dev.type, "--trace",
                                 "--metrics", "--alerts"])
        wall = time.perf_counter() - t0
        counts = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
        require(rc == 0 and "ran=2 skipped=0 failed=0" in out.getvalue(),
                f"obs sweep exit {rc}: {out.getvalue()}")
        sweep_dir = os.path.join(tmp, "obs_sweep")
        files = sorted(os.path.join(sweep_dir, n) for n in os.listdir(sweep_dir)
                       if n == "alerts.jsonl" or n.endswith(
                           (".trace.json", ".metrics.json", ".alerts.jsonl")))
        require(len(files) == 7, f"obs sweep files {files}")
        trace_checked(files)
    log(f"  obs sweep (2 cells, qwen1.5-0.5b full width, {SWEEP_LAYERS} "
        f"layers, {OBS_SWEEP_STEPS} "
        f"steps): {wall:.1f} s wall, "
        + next(line for line in out.getvalue().splitlines()
               if line.startswith("sweep alerts:"))
        + f"; launches { {k: v for k, v in counts.items() if v} }")
    want = sweep_expected("allreduce", 0, OBS_SWEEP_STEPS)
    for k, v in sweep_expected("codist", 0, OBS_SWEEP_STEPS).items():
        want[k] += v
    require(counts == want, f"obs sweep launches {counts} != {want}")
    add(counts)
    return launches


# ----------------------------------------------------------------------------
# phase 16: the paper's own models
# ----------------------------------------------------------------------------

PAPER_STEPS = 3
# the Section-5.1 MLP of examples/multiview_nway.py on its multi-view task
PAPER_MLP = dict(in_dim=64, hidden=(128, 128), num_classes=10)
PAPER_VIEWS = dict(n_views=8, view_dim=8, latent_dim=24, num_classes=10,
                   seed=0)
# the loss kernels' shapes on this path: one row an image (resnet50's 1000
# classes at 8 images a peer, the MLP's 10 classes at 256 samples; the
# heads are fp32) and transformer-big's 14 x 256 target tokens in bf16
PAPER_LOSS_SHAPES = [("T8 V1000 fp32", 8, 1000, torch.float32),
                     ("T256 V10 fp32", 256, 10, torch.float32),
                     ("T3584 V32768 bf16", 14 * 256, 32768, torch.bfloat16)]


def frozen_leaves(params, mask) -> list:
    """Clones of the leaves of ``params`` whose ``mask`` leaf is 0."""
    from repro_torch.tree import tree_leaves
    return [p.detach().clone() for p, m in zip(tree_leaves(params),
                                               tree_leaves(mask)) if m == 0]


def paper_train(label: str, model, cd, tc, batches, dev, want, state=None,
                trainable=None):
    """``train_codist`` over ``batches`` (one a step, on the card) from
    ``state`` (None: drawn from ``tc.seed``), launch counts set to 0 just
    before and read just after: History finite, loss-kernel launches equal
    to ``want``. Prints the losses, the wall ms of each step after step 0
    (from the loop's request for its batch to the next one's; each step
    ends in a sync), peak memory, and the device's busy share of 2 more
    steps (torch.profiler). Returns (state, records, launches)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import (build_train_step, resolve_strategy,
                                   train_codist)
    steps = len(batches)
    feed, stamps = stamped(batches, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    state, hist = train_codist(model, cd, tc, feed, log_every=1, state=state,
                               trainable=trainable, device=dev)
    sync(dev)
    t_end = time.perf_counter()
    got = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = finite_records(hist, f"paper {label}")
    require(len(recs) == steps, f"paper {label}: {len(recs)} History steps")
    walls = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:] + [t_end])]
    step_ms = float(np.mean(walls))
    log(f"paper {label}: loss by step "
        f"{[round(r['loss'], 4) for r in recs]}, distill "
        f"{[round(r['distill_loss'], 6) for r in recs]}; {step_ms:.1f} ms "
        f"wall a step (steps 1-{steps - 1}: "
        f"{', '.join(f'{w:.1f}' for w in walls)}), peak {peak:.2f} GiB, "
        f"comm_bytes {recs[-1]['comm_bytes']:.0f}; launches "
        f"{ {k: v for k, v in got.items() if v} }")
    require(got == want, f"paper {label}: launches {got} != {want}")
    bundle = build_train_step(model, tc, cd, resolve_strategy(cd), trainable)
    profile_device(lambda: bundle.apply(state, batches[-1], steps), step_ms,
                   2, "step")
    return state, recs, got


def phase_paper(dev: torch.device):
    """The paper's own models at full width and depth through
    ``build_model`` and ``train_codist`` / ``train_allreduce``: resnet50 (2
    peers, 8 images of 224^2 a peer, mse, 3 codist steps, then 1 all-reduce
    step), wrn28x10 (2 peers, 128 images of 32^2, mse, ``freeze_mask(
    ("stem", "s0"))`` as ``trainable``: the frozen leaves bit-unchanged),
    transformer-big (2 peers, 14 x 256 source and target tokens, bf16
    activations, fp32 masters, AdamW) and the multi-view MLP (8 peers, 256
    samples, kl, alpha0 2, each peer its own view); every loss-kernel
    launch as ``codist_loss``'s loop makes it. Then the loss kernels at this
    path's shapes (``PAPER_LOSS_SHAPES``), and the reduced models in fp32 on
    the card against the CPU. Returns (the path's launches, the kernels'
    times by shape)."""
    from repro_torch.configs import CodistConfig, TrainConfig, get_config
    from repro_torch.data import (MarkovLM, MultiViewTask,
                                  classification_batch, make_lm_batch,
                                  multiview_batch)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.conv import freeze_mask
    from repro_torch.models.mlp import MLP, MLPConfig
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (PredictionExchange, stack_batches,
                                   train_allreduce)
    from repro_torch.tree import tree_leaves
    log(f"paper: TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
        f"TF32 {torch.backends.cudnn.allow_tf32} (fp32 convolutions and heads "
        "run in full fp32)")
    launches = dict.fromkeys(ALL_LOSS_KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    gen = torch.Generator(device=dev)
    steps = PAPER_STEPS
    # SGD-momentum, the paper's vision optimizer, at a rate these random
    # inits survive: the reference's blocks end in a GroupNorm of scale 1
    # (no zero-init residual), so the first logits are large, and lr 0.1
    # or 0.01 diverges within 2 steps on this data (wrn28x10 at 8 images
    # a peer on the CPU; 1e-3 still oscillates there)
    sgd = TrainConfig(lr=1e-3, lr_schedule="constant", warmup_steps=0,
                      total_steps=steps, optimizer="sgdm", weight_decay=5e-4)

    def images(cfg, b, k):
        gen.manual_seed(1000 + k)
        return classification_batch(gen, b, 3072, cfg.num_classes,
                                    image=True, image_size=cfg.image_size)

    # ---- (a) resnet50: 3 codist steps, then 1 all-reduce step ----
    t0 = time.perf_counter()
    cfg = get_config("resnet50")
    model = build_model(cfg)
    batches = [stack_batches([images(cfg, 8, k)] * 2) for k in range(steps)]
    state, _r, got = paper_train(
        "resnet50 codist (2 peers x 8 images 224^2, mse)", model,
        CodistConfig(n_models=2), sgd, batches, dev,
        expected_launches(2, "mse", steps, combined=True, task_ce=False,
                          standalone=0))
    add(got)
    n_params = sum(p.numel() for p in tree_leaves(state.params[0]))
    # where the memory goes: one peer's forward (the tensors autograd
    # saves) and its backward, above what was allocated before
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    one = {k: v[0] for k, v in batches[0].items()}
    logits, _ = model.forward(state.params[0], one)
    saved = torch.cuda.memory_allocated() - base
    torch.autograd.grad(logits.float().square().mean(),
                        tree_leaves(state.params[0]))
    sync(dev)
    log(f"paper resnet50 memory, one peer at 8 images: the forward saves "
        f"{saved / 2**30:.2f} GiB for the backward; forward and backward "
        f"peak {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB "
        "above the state and batches")
    del state, logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ta = time.perf_counter()
    _s, hist = train_allreduce(model, replace(sgd, total_steps=1),
                               iter([images(cfg, 8, 0)]), log_every=1,
                               device=dev)
    sync(dev)
    got = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
    recs = finite_records(hist, "paper resnet50 all-reduce")
    log(f"paper resnet50 all-reduce (8 images): loss {recs[0]['loss']:.4f}, "
        f"{(time.perf_counter() - ta) * 1e3:.1f} ms wall with the init, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{n_params / 1e6:.2f} M params a peer; launches "
        f"{ {k: v for k, v in got.items() if v} }")
    want = dict.fromkeys(ALL_LOSS_KERNELS, 0)
    want["fused_cross_entropy_parts"] = want["fused_cross_entropy_grad"] = 1
    require(got == want, f"paper resnet50 all-reduce launches {got}")
    add(got)
    del _s, hist, batches
    torch.cuda.empty_cache()
    log(f"paper resnet50: {time.perf_counter() - t0:.1f} s")

    # ---- (b) wrn28x10 with a frozen stem and stage 0 ----
    t0 = time.perf_counter()
    cfg = get_config("wrn28x10")
    model = build_model(cfg)
    cd = CodistConfig(n_models=2)
    gen.manual_seed(28)
    opt_init, _ = make_optimizer(sgd.optimizer)
    state = PredictionExchange(cd).init_state(model, sgd, gen, opt_init,
                                              device=dev)
    mask = freeze_mask(state.params[0], ("stem", "s0"))
    before = [frozen_leaves(p, mask) for p in state.params]
    head0 = state.params[0]["head"].detach().clone()
    batches = [stack_batches([images(cfg, 128, k)] * 2) for k in range(steps)]
    state, _r, got = paper_train(
        "wrn28x10 codist (2 peers x 128 images 32^2, mse, stem + s0 frozen)",
        model, cd, replace(sgd, lr=1e-4), batches, dev,
        expected_launches(2, "mse", steps, combined=True, task_ce=False,
                          standalone=0), state=state, trainable=mask)
    add(got)
    after = [frozen_leaves(p, mask) for p in state.params]
    same = all(bits_equal(a, b) for pa, pb in zip(before, after)
               for a, b in zip(pa, pb))
    require(same and len(before[0]) > 0,
            "paper wrn28x10: a frozen leaf changed")
    require(not torch.equal(state.params[0]["head"], head0),
            "paper wrn28x10: the trainable head did not move")
    log(f"paper wrn28x10: {len(before[0])} frozen leaves a peer "
        f"({sum(t.numel() for t in before[0]) / 1e6:.2f} M params) "
        f"bit-unchanged after {steps + 2} steps; "
        f"{time.perf_counter() - t0:.1f} s")
    del state, before, after, batches
    torch.cuda.empty_cache()

    # ---- (c) transformer-big: source tokens, bf16 activations ----
    t0 = time.perf_counter()
    cfg = get_config("transformer-big")
    model = build_model(cfg)
    task = MarkovLM(vocab=min(cfg.vocab_size, 512), seed=0,
                    effective_vocab=256)
    batches = []
    for k in range(steps):
        one = make_lm_batch(task, 14, 256, k, None, seed=0, device=dev)
        gen.manual_seed(2000 + k)
        one["src_tokens"] = torch.randint(0, cfg.vocab_size, (14, 256),
                                          generator=gen, device=dev,
                                          dtype=torch.int32)
        batches.append(stack_batches([one] * 2))
    adam = TrainConfig(lr=1e-3, lr_schedule="constant", warmup_steps=0,
                       total_steps=steps, optimizer="adamw",
                       label_smoothing=0.1)
    state, _r, got = paper_train(
        f"transformer-big codist (2 peers x 14 x 256 tokens, {cfg.dtype} "
        "activations, fp32 masters, AdamW, mse)", model,
        CodistConfig(n_models=2), adam, batches, dev,
        expected_launches(2, "mse", steps, combined=True, task_ce=False,
                          standalone=0))
    add(got)
    del state, batches
    torch.cuda.empty_cache()
    log(f"paper transformer-big: {time.perf_counter() - t0:.1f} s")

    # ---- (d) the Section-5.1 MLP: 8 peers, one view each ----
    t0 = time.perf_counter()
    model = MLP(MLPConfig(**PAPER_MLP))
    mv = MultiViewTask(**PAPER_VIEWS)
    batches = []
    for k in range(steps):
        raw = multiview_batch(mv, 256, k, device=dev)
        batches.append(stack_batches([
            {"features": raw["features"] * mv.view_mask(i % mv.n_views, dev),
             "labels": raw["labels"]} for i in range(8)]))
    state, _r, got = paper_train(
        "multi-view MLP codist (8 peers x 256, kl, alpha0 2)", model,
        CodistConfig(n_models=8, distill_loss="kl", alpha0=2.0),
        replace(adam, lr=3e-3, label_smoothing=0.0), batches, dev,
        expected_launches(8, "kl", steps, combined=True, task_ce=False,
                          standalone=6))
    add(got)
    del state, batches
    log(f"paper MLP: {time.perf_counter() - t0:.1f} s")

    rows = paper_loss_times(dev)
    rows["fused_cross_entropy_grad"]["T256 V10 fp32 in turns"] = \
        row7_in_turns(dev)
    paper_parity(dev)
    return launches, rows


def _flat_outputs(out) -> list:
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat_outputs(o)]
    return [out]


def paper_loss_times(dev: torch.device, shapes=None,
                     what: str = "paper") -> dict:
    """Rows 6, 7, 12 and 13 (and 9, 11 at the MLP's shape) against their
    plain versions at ``shapes`` (default ``PAPER_LOSS_SHAPES``), with
    kernel, plain and library times and the bound; returns {kernel: {shape:
    record}}."""
    import torch.nn.functional as F

    from repro_torch.kernels import (fused_ce_distill_grad,
                                     fused_ce_distill_grad_plain,
                                     fused_ce_distill_parts,
                                     fused_ce_distill_parts_plain,
                                     fused_cross_entropy_grad,
                                     fused_cross_entropy_grad_plain,
                                     fused_cross_entropy_parts,
                                     fused_cross_entropy_parts_plain,
                                     fused_distill_kl_grad,
                                     fused_distill_kl_grad_plain,
                                     fused_distill_kl_parts,
                                     fused_distill_kl_parts_plain)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    rows = {}
    for si, (label, t, v, dtype) in enumerate(shapes or PAPER_LOSS_SHAPES):
        x, tg, lb, g = loss_inputs(t, v, dtype, dev, 300 + si)
        gd = g[2].contiguous()
        es = x.element_size()
        lb64 = lb.long()
        xr = x.detach().clone().requires_grad_(True)
        lib_y = F.cross_entropy(xr, lb64, reduction="none")
        logz = fused_cross_entropy_parts_plain(x, lb)[2]

        def bound(kname, mode="mse"):
            return loss_bound(kname, t, v, es, mode)

        # name, mode, kernel, plain, library call, bound, is a gradient
        specs = [
            ("fused_cross_entropy_parts", "",
             lambda: fused_cross_entropy_parts(x, lb),
             lambda: fused_cross_entropy_parts_plain(x, lb),
             lambda: F.cross_entropy(x, lb64, reduction="none"),
             bound("fused_cross_entropy_parts"), False),
            ("fused_cross_entropy_grad", "",
             lambda: fused_cross_entropy_grad(x, lb, logz, g[0], g[1]),
             lambda: fused_cross_entropy_grad_plain(x, lb, logz, g[0], g[1]),
             lambda: torch.autograd.grad(lib_y, xr, g[0], retain_graph=True),
             bound("fused_cross_entropy_grad"), True)]
        for mode in (("mse", "kl") if t == 256 else ("mse",)):
            res = fused_ce_distill_parts_plain(x, tg, lb, mode)[1]
            specs += [
                ("fused_ce_distill_parts", mode,
                 lambda m=mode: fused_ce_distill_parts(x, tg, lb, m),
                 lambda m=mode: fused_ce_distill_parts_plain(x, tg, lb, m),
                 None, bound("fused_ce_distill_parts", mode), False),
                ("fused_ce_distill_grad", mode,
                 lambda m=mode, r=res: fused_ce_distill_grad(
                     x, tg, lb, r, g[0], g[1], g[2], m,
                     need_target_grad=False),
                 lambda m=mode, r=res: fused_ce_distill_grad_plain(
                     x, tg, lb, r, g[0], g[1], g[2], m,
                     need_target_grad=False),
                 None, bound("fused_ce_distill_grad", mode), True)]
        if t == 256:
            kres = fused_distill_kl_parts_plain(x, tg)[1:]
            specs += [
                ("fused_distill_kl_parts", "kl",
                 lambda: fused_distill_kl_parts(x, tg),
                 lambda: fused_distill_kl_parts_plain(x, tg), None,
                 bound("fused_distill_kl_parts"), False),
                ("fused_distill_kl_grad", "kl",
                 lambda: fused_distill_kl_grad(x, tg, *kres, gd,
                                               need_target_grad=False),
                 lambda: fused_distill_kl_grad_plain(x, tg, *kres, gd,
                                                     need_target_grad=False),
                 None, bound("fused_distill_kl_grad"), True)]
        errs = {}
        for name, mode, kern, plain, lib, (b_ms, b_by), grad in specs:
            outs_k = [o for o in _flat_outputs(kern()) if o is not None]
            outs_p = [o for o in _flat_outputs(plain()) if o is not None]
            require(len(outs_k) == len(outs_p), f"{name} {label}: outputs")
            err = max(check_loss_output(name, label, a, b, grad,
                                        dtype == torch.float32, errs)
                      for a, b in zip(outs_k, outs_p))
            r = {"ms": time_ms(kern, flush, iters=20),
                 "plain_ms": time_ms(plain, flush, iters=5, warmup=1),
                 "library_ms": None if lib is None else time_ms(lib, flush,
                                                                iters=20),
                 "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
            key = f"{label}{' ' + mode if mode else ''}"
            rows.setdefault(name, {})[key] = r
            lib_txt = ("—" if r["library_ms"] is None
                       else f"{r['library_ms']:.4f} ms")
            log(f"  {what} shape {key}: {name} kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {lib_txt}  bound "
                f"{b_ms:.3e} ms ({b_by}); max|kernel-plain| {err:.2e}")
        del xr, lib_y
    del flush
    torch.cuda.empty_cache()
    return rows


ROW7_TURNS = 10


def row7_in_turns(dev: torch.device) -> dict:
    """Row 7 (``fused_cross_entropy_grad``) at the paper path's T 256 /
    V 10 fp32 and its library backward (``F.cross_entropy``'s autograd) on
    the same inputs, timed in turns in this one process: kernel, library,
    kernel, ... ROW7_TURNS times (20 calls each, the L2 flushed before
    every call). Returns the medians and every turn's time."""
    import torch.nn.functional as F

    from repro_torch.kernels import (fused_cross_entropy_grad,
                                     fused_cross_entropy_parts_plain)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    x, _tg, lb, g = loss_inputs(256, 10, torch.float32, dev, 301)
    logz = fused_cross_entropy_parts_plain(x, lb)[2]
    xr = x.detach().clone().requires_grad_(True)
    lib_y = F.cross_entropy(xr, lb.long(), reduction="none")
    kern = lambda: fused_cross_entropy_grad(x, lb, logz, g[0], g[1])  # noqa: E731
    lib = lambda: torch.autograd.grad(lib_y, xr, g[0], retain_graph=True)  # noqa: E731
    ks, ls = [], []
    for _ in range(ROW7_TURNS):
        ks.append(time_ms(kern, flush, iters=20))
        ls.append(time_ms(lib, flush, iters=20))
    out = {"ms": float(np.median(ks)), "library_ms": float(np.median(ls)),
           "turns_ms": ks, "library_turns_ms": ls}
    log(f"  row 7 at T 256 / V 10 fp32 in {ROW7_TURNS} turns: kernel median "
        f"{out['ms']:.4f} ms ({min(ks):.4f}..{max(ks):.4f}), library backward "
        f"median {out['library_ms']:.4f} ms ({min(ls):.4f}..{max(ls):.4f})")
    del flush, xr, lib_y
    torch.cuda.empty_cache()
    return out


def paper_parity(dev: torch.device) -> None:
    """The reduced resnet50 and wrn28x10, transformer-big reading frames
    and source tokens, and the 8-peer MLP, in fp32 (TF32 off): 3 codist
    steps through ``train_codist`` on the card (the kernels) and on the CPU
    (their plain versions) from the same initial trees and batches, made on
    the CPU; History losses and comm_bytes within 1e-5 relative, the card's
    launches as ``codist_loss``'s loop makes them."""
    from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
    from repro_torch.data import (MultiViewTask, classification_batch,
                                  multiview_batch)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.mlp import MLP, MLPConfig
    from repro_torch.optim import make_optimizer
    from repro_torch.train import stack_batches, train_codist
    from repro_torch.train.state import CodistState, trainable_params
    from repro_torch.tree import tree_map
    gen = torch.Generator()
    steps = PAPER_STEPS
    tc = TrainConfig(lr=0.05, warmup_steps=0, total_steps=steps,
                     optimizer="sgdm", label_smoothing=0.1, fused_losses=True)
    mv = MultiViewTask(**PAPER_VIEWS)

    def conv_batches(cfg):
        out = []
        for k in range(steps):
            gen.manual_seed(3000 + k)
            one = classification_batch(gen, 4, 96, cfg.num_classes,
                                       image=True, image_size=cfg.image_size)
            out.append(stack_batches([one] * 2))
        return out

    def encdec_batches(cfg):
        out = []
        for k in range(steps):
            gen.manual_seed(4000 + k)
            one = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                           generator=gen),
                   "labels": torch.randint(0, cfg.vocab_size, (2, 16),
                                           generator=gen),
                   "mask": (torch.rand((2, 16), generator=gen) > 0.2).float()}
            if cfg.num_audio_frames:
                one["frames"] = torch.randn(
                    (2, cfg.num_audio_frames, cfg.d_model), generator=gen)
            else:
                one["src_tokens"] = torch.randint(0, cfg.vocab_size, (2, 12),
                                                  generator=gen)
            out.append(stack_batches([one] * 2))
        return out

    def mlp_batches():
        out = []
        for k in range(steps):
            raw = multiview_batch(mv, 64, k, device="cpu")
            out.append(stack_batches([
                {"features": raw["features"] * mv.view_mask(i, "cpu"),
                 "labels": raw["labels"]} for i in range(8)]))
        return out

    mse2 = expected_launches(2, "mse", steps, combined=True, task_ce=False,
                             standalone=0)
    frames = get_reduced("transformer-big")
    tokens = replace(frames, num_audio_frames=0)
    cases = [
        ("resnet50-reduced", build_model(get_reduced("resnet50")),
         CodistConfig(n_models=2), conv_batches(get_reduced("resnet50")),
         mse2),
        ("wrn28x10-reduced", build_model(get_reduced("wrn28x10")),
         CodistConfig(n_models=2), conv_batches(get_reduced("wrn28x10")),
         mse2),
        ("transformer-big-reduced frames", build_model(frames),
         CodistConfig(n_models=2), encdec_batches(frames), mse2),
        ("transformer-big-reduced source tokens", build_model(tokens),
         CodistConfig(n_models=2), encdec_batches(tokens), mse2),
        ("MLP 8 peers kl", MLP(MLPConfig(**PAPER_MLP)),
         CodistConfig(n_models=8, distill_loss="kl", alpha0=2.0),
         mlp_batches(), expected_launches(8, "kl", steps, combined=True,
                                          task_ce=False, standalone=6)),
    ]
    worst = 0.0
    for name, model, cd, batches, want in cases:
        gen.manual_seed(7)
        init = [model.init(gen, device="cpu") for _ in range(cd.n_models)]
        recs = {}
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            params = trainable_params(tree_map(
                lambda p: p.detach().clone().to(d), init))
            opt_init, _ = make_optimizer(tc.optimizer)
            state = CodistState(params, opt_init(params), 0)
            reset_launch_counts()
            _s, hist = train_codist(
                model, cd, tc, lambda k: {a: v.to(d)
                                          for a, v in batches[k].items()},
                log_every=1, state=state, device=d)
            recs[where] = finite_records(hist, f"paper parity {name}")
            if where == "card":
                got = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
                require(got == want, f"paper parity {name}: card launches "
                        f"{got} != {want}")
        for a, c in zip(recs["cpu"], recs["card"]):
            for m in ("loss", "task_loss", "distill_loss", "comm_bytes"):
                rel = abs(c[m] - a[m]) / max(abs(a[m]), 1e-12)
                worst = max(worst, rel)
                require(rel <= 1e-5, f"paper parity {name} step {a['step']} "
                        f"{m}: card {c[m]} vs cpu {a[m]} (rel {rel:.2e})")
        log(f"paper parity {name}: card vs CPU loss by step "
            + "; ".join(f"{a['loss']:.7f}/{c['loss']:.7f}"
                        for a, c in zip(recs["cpu"], recs["card"])))
    log(f"paper parity: worst relative difference {worst:.2e} (tol 1e-5)")


# ----------------------------------------------------------------------------
# phase 17: the MoE and hybrid families (grok-1, arctic, jamba)
# ----------------------------------------------------------------------------

# serving depth of each family at full width: as many layers as one card
# holds beside the fleet's pools (bf16 weights): grok-1 4 of 64 (~42 GB),
# arctic 2 of 35 (~55 GB), jamba one 8-layer step of 32 (~27 GB)
FAMILY_LAYERS = {"grok-1-314b": 4, "arctic-480b": 2, "jamba-v0.1-52b": 8}
# prompts of at most 128 tokens: a jamba prefill longer than one scan chunk
# must be a multiple of it (the reference's mamba_scan asserts)
FAMILY_PROMPT, FAMILY_NEW, FAMILY_REQUESTS = 128, 16, 16
FAMILY_BATCH = 4          # Engine.generate's batch
FAMILY_TRAIN_T = 512      # training tokens a peer (1 x 512)
# trained at 1 layer: grok-1, and internvl2 (~3.0 B parameters a peer with
# its two vocab matrices) with its patch prefix
TRAIN_FAMILIES = ("grok-1-314b", "internvl2-76b")
FAMILY_STEPS = 3


def family_fleet_config():
    """16 slots of blocks of 16, room for a prompt of FAMILY_PROMPT and the
    gather tick's 32 new tokens."""
    from repro_torch.serve.fleet import FleetConfig
    return FleetConfig(max_slots=S, block_size=16, num_blocks=1025,
                       max_blocks_per_slot=-(-(FAMILY_PROMPT + 32) // 16),
                       fused_attention=True)


def engine_streams(model, params, wl, dev) -> dict:
    """Every request of ``wl`` through ``Engine.generate`` in ragged batches
    of FAMILY_BATCH (bf16 cache): {rid: tokens}, each cut to its request's
    max_new."""
    from repro_torch.serve import Engine
    eng = Engine(model, params, cache_dtype=torch.bfloat16, device=dev)
    out = {}
    reqs = wl.requests
    for i in range(0, len(reqs), FAMILY_BATCH):
        group = reqs[i:i + FAMILY_BATCH]
        lens = [r.prompt_len for r in group]
        toks = torch.zeros((len(group), max(lens)), dtype=torch.long,
                           device=dev)
        for j, r in enumerate(group):
            toks[j, :r.prompt_len] = torch.as_tensor(r.prompt, device=dev)
        res = eng.generate({"tokens": toks}, max(r.max_new for r in group),
                           prompt_lens=lens)
        for j, r in enumerate(group):
            out[r.rid] = res.tokens[j, max(lens):max(lens) + r.max_new].tolist()
    return out


def family_serve(arch: str, dev: torch.device, launches: dict,
                 summary: dict) -> None:
    """One family at full width and FAMILY_LAYERS depth, one seeded bf16
    weight set shared by 2 fleet peers: the bursty fleet (bf16 pools, rows
    1 and 2 counted exactly), the same requests through Engine.generate at
    batch 4 (tokens compared, each request's first divergence with the
    fleet's top-2 margin there), one fused-vs-gather tick on 16 live slots
    (row 3) with 5 timed fused ticks and their device profile; for grok-1
    also the fleet over int8 pools (rows 1q and 4)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.fleet import generate_workload
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(arch), num_layers=FAMILY_LAYERS[arch])
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2500)
    params = model.init(gen, device=dev, weight_dtype=torch.bfloat16)
    sync(dev)
    n_params = sum(t.numel() for _p, t in _leaves(params))
    log(f"families {arch}: {cfg.num_layers} of {get_config(arch).num_layers}"
        f" layers at full width (d {cfg.d_model}, {cfg.num_heads} over "
        f"{cfg.num_kv_heads} KV heads, d_ff {cfg.d_ff}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, V "
        f"{cfg.padded_vocab}), {n_params / 1e9:.2f} B params in bf16, "
        f"initialised in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    fc = family_fleet_config()
    wl = generate_workload("bursty", FAMILY_REQUESTS, cfg.padded_vocab,
                           seed=5, max_prompt=FAMILY_PROMPT,
                           max_new=FAMILY_NEW)
    margins = {}
    router, _rep, counts, walls, _w = serve_run(
        model, [params, params], fc, wl, torch.bfloat16, dev,
        f"families {arch} bf16", margins=margins)
    n_attn = attn_sublayers(router.engines[0].pool)
    fleet = {r.request.rid: r.tokens for r in router._primaries}
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    del router
    t1 = time.perf_counter()
    single = engine_streams(model, params, wl, dev)
    sync(dev)
    engine_s = time.perf_counter() - t1
    share, gaps = compare_streams(fleet, single,
                                  f"families {arch}: Engine.generate (batch "
                                  f"{FAMILY_BATCH}, bf16) against the fleet",
                                  margins)
    eng, active, tokens, g_counts, tick_ms, tol = tick_check(
        model, params, fc, wl, torch.bfloat16, dev)
    # the engine's dense decode and the fleet's paged one round apart in
    # bf16, and an expert flip at a near-tie changes a request from there
    # on; a fault in either path leaves most tokens and first divergences
    # at wide margins
    med = float(np.median(gaps)) if gaps else 0.0
    log(f"families {arch}: Engine.generate vs fleet {share:.1%} equal "
        f"(>= 75%), median first-divergence margin {med:.4f} (<= {tol:.4f})")
    require(share >= 0.75, f"families {arch}: only {share:.1%} of "
            "Engine.generate's tokens equal the fleet's")
    require(med <= tol, f"families {arch}: median first divergence at a "
            f"top-2 margin {med:.4f} > {tol:.4f}")
    require(g_counts["paged_gather"] == 2 * n_attn
            and g_counts["paged_scatter"] == n_attn
            and g_counts["paged_attention_decode"] == 0,
            f"families {arch} gather tick launches {g_counts}")
    launches["paged_gather"] = (launches.get("paged_gather", 0)
                                + g_counts["paged_gather"])
    busy = profile_device(lambda: eng.decode_logits(active, tokens), tick_ms,
                          3, "tick", detail=("decode_", "scatter"))
    del eng
    torch.cuda.empty_cache()
    if arch == "grok-1-314b":
        router, _rep, counts, _t, _w = serve_run(
            model, [params, params], fc, wl, torch.int8, dev,
            f"families {arch} int8")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        # another function of the weights (int8 K/V), so only printed;
        # rows 1q and 4 at these heads are held in the kernels phase
        compare_streams(fleet, router, f"families {arch}: int8 pools "
                        "against bf16 pools (for information)")
        del router
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary[arch] = dict(layers=cfg.num_layers, attn=n_attn,
                         fleet_tick_ms=float(np.mean(walls)),
                         tick_ms=tick_ms, busy=busy, equal=share,
                         margins=gaps, engine_s=engine_s, peak=peak)
    log(f"families {arch}: fleet {np.mean(walls):.2f} ms wall a tick, 16 "
        f"live slots {tick_ms:.2f} ms wall a tick, device busy "
        + (f"{busy / tick_ms:.1%}" if busy else "not measured")
        + f"; Engine.generate {engine_s:.2f} s for {len(wl.requests)} "
        f"requests; {n_attn} attention sub-layers (rows 1, 2 per tick); "
        f"peak {peak:.2f} GiB; {time.perf_counter() - t0:.1f} s")
    del params, model
    torch.cuda.empty_cache()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def family_train(dev: torch.device, launches: dict,
                 arch: str = "grok-1-314b") -> None:
    """``arch`` at full width, 1 of its layers (grok-1: 1 of 64; internvl2:
    1 of 80, its 256 seeded patch embeddings before the text): 2 peers of
    seeded bf16 weights, plain SGD (no buffer; the update in slices of each
    leaf), 1 x FAMILY_TRAIN_T tokens a peer, FAMILY_STEPS codist steps
    (mse, rows 12 and 13 at V 131072 / 128256), then 1 all-reduce step of
    peer 0 (rows 6, 7): launches exact, aux_loss (> 0 with MoE layers, 0
    without), ms a step, busy share and peak memory."""
    from repro_torch.configs import CodistConfig, TrainConfig, get_config
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import OptState
    from repro_torch.train import stack_batches, train_allreduce
    from repro_torch.train.state import (CodistState, TrainState,
                                         trainable_params)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    full = get_config(arch)
    cfg = replace(full, num_layers=1)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2600)
    params = trainable_params([model.init(gen, device=dev,
                                          weight_dtype=torch.bfloat16)
                               for _ in range(2)])
    # plain SGD keeps no buffer: 2 peers' weights and gradients take ~49
    # GiB, and a momentum-0 buffer (the gradient again, 24 GiB even in
    # bf16) leaves no room on an 80 GB card for the backward's transients
    tc = TrainConfig(lr=1e-3, lr_schedule="constant", warmup_steps=0,
                     total_steps=FAMILY_STEPS, optimizer="sgdm", momentum=0.0,
                     weight_decay=0.0)
    state = CodistState(params, OptState(0, None, None), 0)
    sync(dev)
    log(f"families train: {arch} 1 of {full.num_layers} layers at full "
        "width, 2 peers of bf16 weights (plain SGD, no buffer) initialised in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    task = MarkovLM(vocab=min(cfg.vocab_size, 512), seed=0,
                    effective_vocab=256)
    batches = []
    for k in range(FAMILY_STEPS):
        one = make_lm_batch(task, 1, FAMILY_TRAIN_T, k, None, seed=0,
                            device=dev)
        if cfg.num_patches:
            one["patches"] = 0.1 * torch.randn(
                (1, cfg.num_patches, cfg.d_model), generator=gen, device=dev)
        batches.append(stack_batches([one] * 2))
    state, recs, got = paper_train(
        f"families {arch} codist (2 peers x 1 x {FAMILY_TRAIN_T} tokens"
        + (f" after {cfg.num_patches} patches" if cfg.num_patches else "")
        + ", bf16, SGD, mse)", model, CodistConfig(n_models=2), tc, batches,
        dev, expected_launches(2, "mse", FAMILY_STEPS, combined=True,
                               task_ce=False, standalone=0), state=state)
    log(f"families train: {arch} aux_loss by step "
        f"{[round(r['aux_loss'], 6) for r in recs]}")
    moe = cfg.moe is not None
    require(all((r["aux_loss"] > 0) == moe for r in recs),
            f"families train {arch}: aux loss {recs} with MoE layers {moe}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    one = {k: v[0] for k, v in batches[0].items()}
    p0 = state.params[0]
    del state, batches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ta = time.perf_counter()
    _s, hist = train_allreduce(
        model, replace(tc, total_steps=1), iter([one]), log_every=1,
        state=TrainState(p0, OptState(0, None, None), 0), device=dev)
    sync(dev)
    got = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
    rec = finite_records(hist, f"families {arch} all-reduce")[0]
    want = dict.fromkeys(ALL_LOSS_KERNELS, 0)
    want["fused_cross_entropy_parts"] = want["fused_cross_entropy_grad"] = 1
    log(f"families train: {arch} all-reduce step of peer 0: loss "
        f"{rec['loss']:.4f}"
        f", aux {rec['aux_loss']:.6f}, "
        f"{(time.perf_counter() - ta) * 1e3:.1f} ms wall, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in got.items() if v} }")
    require(got == want, f"families {arch} all-reduce launches {got} != "
            f"{want}")
    for k, v in got.items():
        launches[k] += v
    del _s, hist, p0, one
    torch.cuda.empty_cache()
    log(f"families train {arch}: {time.perf_counter() - t0:.1f} s")


def family_parity(dev: torch.device, archs=tuple(FAMILY_LAYERS),
                  what: str = "families parity") -> None:
    """The reduced configs of ``archs`` (the three families) in fp32 (TF32
    off), the card against the CPU from the same weights and inputs: 3 codist steps
    (History losses and aux within 1e-5 relative, loss-kernel launches
    exact), and a bursty fleet of 2 peers over fp32 pools (every
    FleetReport field, and so the stream digest, equal)."""
    from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.serve.fleet import (FleetConfig, FleetRouter,
                                         generate_workload)
    from repro_torch.train import train_codist
    from repro_torch.train.state import CodistState, trainable_params
    from repro_torch.tree import tree_map
    steps = FAMILY_STEPS
    tc = TrainConfig(lr=0.05, warmup_steps=0, total_steps=steps,
                     optimizer="sgdm", label_smoothing=0.1, fused_losses=True)
    want = expected_launches(2, "mse", steps, combined=True, task_ce=False,
                             standalone=0)
    worst = 0.0
    for arch in archs:
        cfg = get_reduced(arch)
        model = build_model(cfg)
        gen = torch.Generator()
        gen.manual_seed(31)
        init = [model.init(gen, device="cpu") for _ in range(2)]
        batches = []
        for _ in range(steps):
            lead = (2, 2, 32)
            batches.append({
                "tokens": torch.randint(0, cfg.vocab_size, lead, generator=gen),
                "labels": torch.randint(0, cfg.vocab_size, lead, generator=gen),
                "mask": (torch.rand(lead, generator=gen) > 0.2).float()})
        recs = {}
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            params = trainable_params(tree_map(
                lambda p: p.detach().clone().to(d), init))
            opt_init, _ = make_optimizer(tc.optimizer)
            reset_launch_counts()
            _s, hist = train_codist(
                model, CodistConfig(n_models=2), tc,
                lambda k: {a: v.to(d) for a, v in batches[k].items()},
                log_every=1, state=CodistState(params, opt_init(params), 0),
                device=d)
            recs[where] = finite_records(hist, f"{what} {arch}")
            if where == "card":
                got = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
                require(got == want, f"{what} {arch}: launches "
                        f"{got} != {want}")
        for a, c in zip(recs["cpu"], recs["card"]):
            for m in ("loss", "task_loss", "distill_loss", "aux_loss",
                      "comm_bytes"):
                rel = abs(c[m] - a[m]) / max(abs(a[m]), 1e-12)
                worst = max(worst, rel)
                require(rel <= 1e-5, f"{what} {arch} step "
                        f"{a['step']} {m}: card {c[m]} vs cpu {a[m]}")
        wl = generate_workload("bursty", 8, cfg.padded_vocab, seed=3,
                               max_prompt=40, max_new=8)
        fc = FleetConfig(max_slots=3, block_size=4, num_blocks=64,
                         max_blocks_per_slot=12, max_prefills_per_step=1)
        reps = {}
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            peers = [tree_map(lambda p: p.detach().to(d), t) for t in init]
            reps[where] = FleetRouter(model, peers, config=fc,
                                      policy="least_loaded",
                                      cache_dtype=torch.float32,
                                      device=d).run(wl).to_dict()
        bad = {k: (reps["cpu"][k], reps["card"][k]) for k in reps["cpu"]
               if reps["cpu"][k] != reps["card"][k]}
        log(f"{what} {arch} (fp32): card vs CPU loss by step "
            + "; ".join(f"{a['loss']:.7f}/{c['loss']:.7f}"
                        for a, c in zip(recs["cpu"], recs["card"]))
            + f"; aux {recs['card'][-1]['aux_loss']:.7f}; FleetReport "
            f"{len(reps['cpu']) - len(bad)}/{len(reps['cpu'])} fields equal "
            f"({reps['card']['stream_digest'][:16]})")
        require(not bad, f"{what} {arch}: FleetReport fields differ "
                f"card vs CPU: {bad}")
    log(f"{what}: worst relative difference {worst:.2e} (tol 1e-5)")


def phase_families(dev: torch.device, smi_line: str) -> dict:
    """The MoE and hybrid families on the card (module docstring, phase
    17); returns the path's launches of rows 1-4, 6, 7, 12 and 13."""
    launches: dict = {}
    summary: dict = {}
    for arch in FAMILY_LAYERS:
        family_serve(arch, dev, launches, summary)
    for arch in TRAIN_FAMILIES:
        family_train(dev, launches, arch)
    family_parity(dev)
    for arch, r in summary.items():
        log(f"families summary {arch} ({r['layers']} layers, {r['attn']} "
            f"attention): fleet tick {r['fleet_tick_ms']:.2f} ms wall, 16 "
            f"live slots {r['tick_ms']:.2f} ms, busy "
            + (f"{r['busy'] / r['tick_ms']:.1%}" if r["busy"] else
               "not measured")
            + f", Engine tokens equal {r['equal']:.1%}, peak "
            f"{r['peak']:.2f} GiB ({smi_line})")
    return launches


# ----------------------------------------------------------------------------
# phase 18: rwkv6-1.6b (attention-free: no paged pool, no rows 1-4)
# ----------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-1.6b"
# the bursty workload's prompts (4..22 tokens at seed 5) with three set to
# a multiple of the WKV chunk (64), so their prefills take the chunked form
# and the others the sequential scan, as the reference branches
RWKV_ON_CHUNK = {0: 128, 5: 64, 10: 64}
# training: full width, RWKV_TRAIN_LAYERS of 24 layers with each layer
# recomputed in the backward (TrainConfig.remat): the chunked form's
# pairwise decay is (B, 64, 64, H, hd) fp32, 268 MB a chunk at 8 x 512
# tokens, and a layer saves ~6 GB of them for its backward
RWKV_TRAIN_LAYERS, RWKV_TRAIN_B, RWKV_TRAIN_T = 4, 8, 512
RWKV_LOSS_SHAPES = [("T4096 V65536 bf16", RWKV_TRAIN_B * RWKV_TRAIN_T, 65536,
                     torch.bfloat16)]


def rwkv_workload(cfg, n: int, max_prompt: int, max_new: int, seed: int):
    """The seeded bursty workload with the prompts of ``RWKV_ON_CHUNK``'s
    requests lengthened to their lengths (seeded tokens appended)."""
    from repro_torch.serve.fleet import generate_workload
    wl = generate_workload("bursty", n, cfg.padded_vocab, seed=seed,
                           max_prompt=max_prompt, max_new=max_new)
    rng = np.random.default_rng(seed)
    for rid, length in RWKV_ON_CHUNK.items():
        r = wl.requests[rid]
        extra = rng.integers(0, cfg.padded_vocab, length - r.prompt_len)
        wl.requests[rid] = replace(r, prompt=r.prompt + tuple(
            int(x) for x in extra))
    return wl


def rwkv_ticks(model, peer, fc, wl, dev: torch.device):
    """One engine with 16 live slots (the workload's first 16 prompts
    prefilled): 5 decode ticks timed (wall) with rows 1-4 counted (none
    may launch), then 5 more under torch.profiler. Returns (ms a tick,
    busy ms a tick or None, the first tick's max|logits|)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.fleet import FleetEngine, Request
    eng = FleetEngine(model, peer, replace(fc, max_prefills_per_step=S),
                      cache_dtype=torch.bfloat16, device=dev)
    for r in wl.requests[:S]:
        eng.enqueue(Request(r.rid, 0.0, r.prompt, 32))
    eng._intake()
    eng._admit()
    require(len(eng.slots) == S, f"rwkv: only {len(eng.slots)} slots admitted")
    active = np.ones((S,), bool)
    tokens = np.zeros((S, 1), np.int32)
    for s, sl in eng.slots.items():
        tokens[s, 0] = sl.next_token
    first = eng.decode_logits(active, tokens).float()
    require(bool(torch.isfinite(first).all()), "rwkv: non-finite tick logits")
    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(5):
        eng.decode_logits(active, tokens)
    sync(dev)
    tick_ms = (time.perf_counter() - t0) / 5 * 1e3
    counts = {k: launch_counts[k] for k in ROWS_1_TO_4}
    require(not any(counts.values()), f"rwkv ticks launched {counts}")
    ctx = [int(x) for x in eng.pool.lengths]
    log(f"rwkv decode tick (16 live slots, contexts {min(ctx)}..{max(ctx)}): "
        f"{tick_ms:.2f} ms wall a tick over 5 = {S / tick_ms * 1e3:.1f} "
        "tokens/s; rows 1-4 launched 0 times")
    busy = profile_device(lambda: eng.decode_logits(active, tokens), tick_ms,
                          5, "tick")
    return tick_ms, busy, float(first.abs().max())


def rwkv_serve(dev: torch.device, summary: dict) -> None:
    """rwkv6-1.6b at full width and depth, one seeded bf16 weight set shared
    by 2 fleet peers: the bursty fleet over bf16 state rows (no block pool,
    rows 1-4 launched 0 times), the same requests through Engine.generate
    at batch 4 (tokens compared, each request's first divergence with the
    fleet's top-2 margin there), 5 timed ticks of 16 live slots with their
    device profile, Engine.generate's own times at batch 4 (prefill of 64,
    the chunked form; ms a decode step and its busy share), peak
    memory."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(RWKV_ARCH)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2700)
    params = model.init(gen, device=dev, weight_dtype=torch.bfloat16)
    sync(dev)
    n_params = sum(t.numel() for _p, t in _leaves(params))
    log(f"rwkv serve: {RWKV_ARCH} {cfg.num_layers} layers at full width (d "
        f"{cfg.d_model}, {cfg.d_model // cfg.rwkv.head_dim} WKV heads of "
        f"{cfg.rwkv.head_dim}, d_ff {cfg.d_ff}, V {cfg.padded_vocab}), "
        f"{n_params / 1e9:.3f} B params (bf16, the fp32-read leaves fp32), "
        f"initialised in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    fc = family_fleet_config()
    wl = rwkv_workload(cfg, FAMILY_REQUESTS, FAMILY_PROMPT, FAMILY_NEW, 5)
    lens = [r.prompt_len for r in wl.requests]
    on = [n for n in lens if n % 64 == 0]
    log(f"rwkv serve: prompt lengths {lens} ({len(on)} on the 64-token "
        "chunk: chunked prefill; the rest the sequential scan)")
    require(on and len(on) < len(lens), "rwkv: no prompt on or off the chunk")
    margins = {}
    router, rep, _c, walls, wall = serve_run(
        model, [params, params], fc, wl, torch.bfloat16, dev,
        "rwkv bf16", margins=margins)
    pool = router.engines[0].pool
    require(pool.kv == {} and set(pool.states) == {"sub0"},
            f"rwkv: pool kv {list(pool.kv)}, states {list(pool.states)}")
    fleet = {r.request.rid: r.tokens for r in router._primaries}
    del router
    t1 = time.perf_counter()
    single = engine_streams(model, params, wl, dev)
    sync(dev)
    engine_s = time.perf_counter() - t1
    log(f"rwkv Engine.generate at batch {FAMILY_BATCH} (bf16 cache):")
    timings = single_timings(
        model, params, Engine(model, params, cache_dtype=torch.bfloat16,
                              device=dev), FAMILY_BATCH, dev)
    tick_ms, busy, scale = rwkv_ticks(model, params, fc, wl, dev)
    tol = 0.05 * scale
    share, gaps = compare_streams(fleet, single,
                                  f"rwkv: Engine.generate (batch "
                                  f"{FAMILY_BATCH}, bf16) against the fleet",
                                  margins)
    # the engine's batches of 4 and the fleet's 16-slot ticks round apart in
    # bf16 (other GEMM shapes); a fault leaves most tokens and first
    # divergences at wide margins
    med = float(np.median(gaps)) if gaps else 0.0
    log(f"rwkv: Engine.generate vs fleet {share:.1%} equal (>= 75%), median "
        f"first-divergence margin {med:.4f} (<= {tol:.4f})")
    require(share >= 0.75, f"rwkv: only {share:.1%} of Engine.generate's "
            "tokens equal the fleet's")
    require(med <= tol, f"rwkv: median first divergence at a top-2 margin "
            f"{med:.4f} > {tol:.4f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary.update(fleet_tick_ms=float(np.mean(walls)), fleet_s=wall,
                   tokens=rep.generated_tokens, tick_ms=tick_ms, busy=busy,
                   equal=share, engine_s=engine_s, peak=peak,
                   engine=timings)
    log(f"rwkv serve: fleet {np.mean(walls):.2f} ms wall a tick "
        f"({rep.generated_tokens} tokens in {wall:.2f} s, prefills "
        f"included), 16 live slots {tick_ms:.2f} ms wall a tick, device busy "
        + (f"{busy:.2f} ms ({busy / tick_ms:.1%})" if busy else
           "not measured")
        + f"; Engine.generate {engine_s:.2f} s for {len(wl.requests)} "
        f"requests, at batch {FAMILY_BATCH} {timings['step_ms']:.2f} ms wall "
        f"a decode step; peak {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    del params, model
    torch.cuda.empty_cache()


def rwkv_train(dev: torch.device, launches: dict) -> dict:
    """rwkv6 at full width, RWKV_TRAIN_LAYERS of 24 layers, each layer
    recomputed in the backward: 2 peers of seeded fp32 masters, bf16
    activations, AdamW, 8 x 512 tokens a peer, 3 codist steps (mse, rows 12
    and 13 at V 65536 bf16) and 1 all-reduce step of peer 0 (rows 6, 7):
    launches exact, History finite, ms a step, busy share, peak memory;
    then rows 6, 7, 12 and 13 held against their plain versions and timed
    at this path's shape beside F.cross_entropy and its backward. Returns
    the kernels' records at that shape."""
    from repro_torch.configs import CodistConfig, TrainConfig, get_config
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import stack_batches, train_allreduce
    from repro_torch.train.state import (CodistState, TrainState,
                                         trainable_params)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = replace(get_config(RWKV_ARCH), num_layers=RWKV_TRAIN_LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2800)
    params = trainable_params([model.init(gen, device=dev) for _ in range(2)])
    tc = TrainConfig(lr=1e-3, lr_schedule="constant", warmup_steps=0,
                     total_steps=FAMILY_STEPS, optimizer="adamw", remat=True)
    opt_init, _ = make_optimizer(tc.optimizer)
    state = CodistState(params, opt_init(params), 0)
    sync(dev)
    log(f"rwkv train: {RWKV_TRAIN_LAYERS} of 24 layers at full width, 2 peers "
        f"of fp32 masters (bf16 activations, AdamW, remat) initialised in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    task = MarkovLM(vocab=min(cfg.vocab_size, 512), seed=0,
                    effective_vocab=256)
    batches = [stack_batches([make_lm_batch(task, RWKV_TRAIN_B, RWKV_TRAIN_T,
                                            k, p, seed=0, device=dev)
                              for p in range(2)])
               for k in range(FAMILY_STEPS)]
    state, _recs, got = paper_train(
        f"rwkv codist (2 peers x {RWKV_TRAIN_B} x {RWKV_TRAIN_T} tokens, "
        f"{RWKV_TRAIN_LAYERS} layers, bf16, AdamW, mse)", model,
        CodistConfig(n_models=2), tc, batches, dev,
        expected_launches(2, "mse", FAMILY_STEPS, combined=True,
                          task_ce=False, standalone=0), state=state)
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    one = {k: v[0] for k, v in batches[0].items()}
    p0 = state.params[0]
    del state, batches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ta = time.perf_counter()
    _s, hist = train_allreduce(
        model, replace(tc, total_steps=1), iter([one]), log_every=1,
        state=TrainState(p0, opt_init(p0), 0), device=dev)
    sync(dev)
    got = {k: launch_counts[k] for k in ALL_LOSS_KERNELS}
    rec = finite_records(hist, "rwkv all-reduce")[0]
    want = dict.fromkeys(ALL_LOSS_KERNELS, 0)
    want["fused_cross_entropy_parts"] = want["fused_cross_entropy_grad"] = 1
    log(f"rwkv train: all-reduce step of peer 0: loss {rec['loss']:.4f}, "
        f"{(time.perf_counter() - ta) * 1e3:.1f} ms wall (its first step), "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in got.items() if v} }")
    require(got == want, f"rwkv all-reduce launches {got} != {want}")
    for k, v in got.items():
        launches[k] += v
    del _s, hist, p0, one
    torch.cuda.empty_cache()
    rows = paper_loss_times(dev, RWKV_LOSS_SHAPES, "rwkv")
    log(f"rwkv train: {time.perf_counter() - t0:.1f} s")
    return rows


def rwkv_parity(dev: torch.device) -> None:
    """The reduced rwkv6 in fp32 (TF32 off), the card against the CPU from
    the same weights and inputs: 3 codist steps (History losses within 1e-5
    relative, loss-kernel launches exact), a bursty fleet of 2 peers over
    fp32 state rows (every FleetReport field equal), and Engine.generate's
    tokens, uniform and ragged, equal."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.serve import Engine
    from repro_torch.tree import tree_map
    family_parity(dev, (RWKV_ARCH,), "rwkv parity")
    model = build_model(get_reduced(RWKV_ARCH))
    gen = torch.Generator()
    gen.manual_seed(32)
    params = model.init(gen, device="cpu")
    lens = [70, 64, 9, 33]
    toks = torch.randint(0, model.cfg.padded_vocab, (4, 70), generator=gen)
    outs = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        e = Engine(model, tree_map(lambda x: x.to(d), params),
                   cache_dtype=torch.float32, device=d)
        outs[where] = (e.generate({"tokens": toks[:, :64].to(d)}, 8)
                       .tokens.cpu(),
                       e.generate({"tokens": toks.to(d)}, 8,
                                  prompt_lens=lens).tokens.cpu())
    for name, a, b in zip(("uniform (64: chunked)", "ragged"), outs["cpu"],
                          outs["card"]):
        require(torch.equal(a, b), f"rwkv parity Engine.generate {name}: card "
                "tokens != CPU tokens")
    log(f"rwkv parity: Engine.generate tokens equal card vs CPU, uniform at "
        f"64 (the chunked prefill) and ragged {lens}")


def phase_rwkv(dev: torch.device, smi_line: str):
    """rwkv6-1.6b on the card (module docstring, phase 18); returns the
    path's launches of rows 6, 7, 12 and 13 (rows 1-4: none) and the loss
    kernels' records at its training shape."""
    launches: dict = {}
    summary: dict = {}
    rwkv_serve(dev, summary)
    rows = rwkv_train(dev, launches)
    rwkv_parity(dev)
    eng = summary["engine"]
    log(f"rwkv summary (24 layers): fleet tick {summary['fleet_tick_ms']:.2f} "
        f"ms wall, 16 live slots {summary['tick_ms']:.2f} ms, busy "
        + (f"{summary['busy'] / summary['tick_ms']:.1%}" if summary["busy"]
           else "not measured")
        + f"; Engine.generate batch {FAMILY_BATCH} decode step "
        f"{eng['step_ms']:.2f} ms, busy "
        + (f"{eng['busy_ms'] / eng['step_ms']:.1%}" if eng["busy_ms"]
           else "not measured")
        + f"; Engine tokens equal {summary['equal']:.1%}, peak "
        f"{summary['peak']:.2f} GiB ({smi_line})")
    return launches, rows


# ----------------------------------------------------------------------------
# phase 19: --mode codist-shardmap (one process per model, a gloo pod group)
# ----------------------------------------------------------------------------

# the training CLI's flags for every shardmap run: qwen1.5-0.5b, 2 pods on
# the one card, 2 x 512 tokens a pod, AdamW, 3 steps, no eval
SHARDMAP_ARGV = ["--arch", "qwen1.5-0.5b", "--mode", "codist-shardmap",
                 "--codist-n", "2", "--steps", "3", "--batch", "2", "--seq",
                 "512", "--log-every", "1", "--eval-every", "0",
                 "--optimizer", "adamw"]
# (label, more flags, config overrides over the full config, held against
# PredictionExchange): full width and depth (fp32 masters, bf16) over the
# none and top-64 wires, then 4 of 24 layers in fp32 (TF32 off) with plain
# SGD-momentum at a constant lr from step 0, so that a fault in the scale
# of a pod's gradient moves steps 1 and 2 (AdamW would hide it)
SHARDMAP_JOBS = [
    ("none", ["--compression", "none"], {}, False),
    ("topk 64", ["--compression", "topk", "--topk", "64"], {}, False),
    ("fp32 4 layers none", ["--compression", "none", "--optimizer", "sgdm",
                            "--lr", "0.05", "--warmup", "0",
                            "--lr-schedule", "constant"],
     {"num_layers": 4, "dtype": "float32"}, True)]


def shardmap_smoke_pod(pods, jobs) -> list:
    """One pod of the shardmap phase, spawned by ``spawn_pods``: TF32 off;
    each job trains this pod's model (the full config with the job's
    overrides) through the training CLI's ``run_training`` and a
    ``ShardMapCompressed`` that marks the clock and the exchange's meter
    as each step starts, with the launch counts set to 0 just before and
    read just after, pod 0 under torch.profiler (its kernels' device
    time). Returns per job the History records, the run's seconds, per
    step (from one step's start to the next's, or the end) the wall
    seconds ``step_s`` and the exchange's seconds ``wire_s``, the wire
    bytes that arrived, the peak device memory, ``launches`` and
    ``device_ms`` (pod 0; None elsewhere or when the profiler saw no
    device time)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import (build_parser, codist_config,
                                          run_training)
    from repro_torch.models import build_model
    from repro_torch.train import ShardMapCompressed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    marks: list = []

    class MarkedShardMap(ShardMapCompressed):
        def prepare(self, state, batch_all, k):
            marks.append((time.perf_counter(), pods.wire_s))
            return super().prepare(state, batch_all, k)

    def run(args, model, strategy):
        # the last mark is taken before the profiler stops
        res = run_training(args, model, pods.device, strategy)
        marks.append((time.perf_counter(), pods.wire_s))
        return res

    out = []
    for _label, argv, over, _held in jobs:
        t0 = time.perf_counter()
        args = build_parser().parse_args(argv)
        model = build_model(replace(get_config(args.arch), **over))
        strategy = MarkedShardMap(codist_config(args), pods)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        marks.clear()
        bytes0 = pods.wire_bytes
        reset_launch_counts()
        device_ms = None
        if pods.rank == 0:
            # the kernels alone (no CPU ops): a short event list to sum
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, hist, dt = run(args, model, strategy)
            us = sum(getattr(e, "self_device_time_total", 0.0)
                     for e in prof.key_averages()
                     if getattr(e, "device_type", None)
                     == torch.autograd.DeviceType.CUDA)
            device_ms = us / 1e3 if us > 0 else None
        else:
            state, hist, dt = run(args, model, strategy)
        out.append({
            "records": hist.records, "seconds": dt,
            "step_s": [b[0] - a[0] for a, b in zip(marks, marks[1:])],
            "wire_s": [b[1] - a[1] for a, b in zip(marks, marks[1:])],
            "wire_bytes": pods.wire_bytes - bytes0,
            "peak_bytes": torch.cuda.max_memory_allocated(pods.device),
            "launches": dict(launch_counts), "device_ms": device_ms,
            "job_s": time.perf_counter() - t0})
        del state, model, strategy
    return out


def phase_shardmap(dev: torch.device) -> dict:
    """``--mode codist-shardmap`` on the card (module docstring, phase
    19): the jobs of SHARDMAP_JOBS in 2 spawned pods, launches exact (over
    the none wire rows 12 and 13 a pod a step, the task CE combined with
    the distillation term as in PredictionExchange; over the top-k wire
    rows 6 and 7), finite losses, per job the wall and pod 0's device ms a
    step, the exchange's share of a step, each pod's peak memory and the
    wire's bytes; the fp32 job's losses within 1e-5 relative of
    PredictionExchange on the card (``--mode codist``, same flags and
    weights), its loss moving by more than 100 times that tolerance over
    the 3 steps, and its metered wire bytes equal to ``comm_bytes``; then
    the CLI itself (reduced config). Returns the full-width jobs'
    launches."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_pods
    from repro_torch.launch.train import (build_parser, main as train_main,
                                          run_training)
    from repro_torch.models import build_model
    from repro_torch.train import History
    steps = 3
    jobs = [(label, SHARDMAP_ARGV + flags, over, held)
            for label, flags, over, held in SHARDMAP_JOBS]
    t0 = time.perf_counter()
    results = spawn_pods(shardmap_smoke_pod, 2, (jobs,), device=str(dev),
                         timeout_s=600.0)
    log(f"shardmap: {len(jobs)} jobs in 2 pods on the one card "
        f"({torch.cuda.get_device_name(0)}), "
        f"{time.perf_counter() - t0:.1f} s with the spawn")
    launches: dict = {}
    for j, (label, argv, over, held) in enumerate(jobs):
        pods = [r[j] for r in results]
        topk = "topk" in label
        want = expected_launches(2, "mse", steps, combined=not topk,
                                 task_ce=topk, standalone=0)
        got = {k: sum(p["launches"][k] for p in pods)
               for k in ALL_LOSS_KERNELS}
        require(got == want, f"shardmap {label}: launches {got} != {want}")
        recs = [finite_records(History(p["records"]),
                               f"shardmap {label} pod {r}")
                for r, p in enumerate(pods)]
        require(all(len(x) == steps for x in recs)
                and recs[0] == recs[1],
                f"shardmap {label}: the pods' Histories differ or are short")
        comm = recs[0][-1]["comm_bytes"]
        dev_ms = pods[0]["device_ms"]
        # steps 1.. (step 0 holds each pod's wait for the other's init)
        wall = [float(np.mean(p["step_s"][1:])) * 1e3 for p in pods]
        wire = [float(np.mean(p["wire_s"][1:])) * 1e3 for p in pods]
        log(f"shardmap {label}: loss by step "
            f"{[round(r['loss'], 5) for r in recs[0]]}, distill "
            f"{[round(r['distill_loss'], 6) for r in recs[0]]}; wall a step "
            f"(steps 1-{steps - 1}) "
            + ", ".join(f"pod {r} {w:.1f} ms" for r, w in enumerate(wall))
            + " (pod 0 under torch.profiler); pod 0 device "
            + (f"{dev_ms / steps:.1f} ms a step (all {steps} steps)"
               if dev_ms else "not measured")
            + "; the exchange (host-staged gather) "
            + ", ".join(f"{x:.1f} ms a step ({x / w:.1%})"
                        for x, w in zip(wire, wall))
            + "; peak "
            + ", ".join(f"{p['peak_bytes'] / 2**30:.2f}" for p in pods)
            + f" GiB; wire {pods[0]['wire_bytes']} bytes received a pod in "
            f"{steps} steps, comm_bytes {comm:.0f}; launches "
            f"{ {k: v for k, v in got.items() if v} }; pod 0 "
            f"{pods[0]['seconds']:.1f} s in the run (init included), "
            f"{pods[0]['job_s']:.1f} s in the job")
        if not held:
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            continue
        # the fp32 job: PredictionExchange on the card, same flags
        for p in pods:
            require(p["wire_bytes"] == comm,
                    f"shardmap {label}: metered wire {p['wire_bytes']} bytes"
                    f" != comm_bytes {comm}")
        args = build_parser().parse_args(argv + ["--mode", "codist"])
        _st, hist, _dt = run_training(
            args, build_model(replace(get_config(args.arch), **over)), dev)
        ref = finite_records(hist, f"shardmap {label} PredictionExchange")
        worst = 0.0
        for a, b in zip(ref, recs[0]):
            for m in ("loss", "task_loss", "distill_loss", "comm_bytes"):
                rel = abs(b[m] - a[m]) / max(abs(a[m]), 1e-12)
                worst = max(worst, rel)
                require(rel <= 1e-5, f"shardmap {label} step {a['step']} {m}:"
                        f" {b[m]} vs PredictionExchange {a[m]}")
        moved = abs(ref[-1]["loss"] - ref[0]["loss"]) / abs(ref[0]["loss"])
        require(moved > 1e-3, f"shardmap {label}: the loss moved by only "
                f"{moved:.2e} relative over {steps} steps, too little for "
                "the 1e-5 comparison to see a fault in a gradient's scale")
        log(f"shardmap {label}: losses within {worst:.2e} relative of "
            f"PredictionExchange (tol 1e-5), the loss moved {moved:.2e} "
            "relative over the steps; metered wire bytes == "
            f"comm_bytes ({comm:.0f})")
        del _st
        torch.cuda.empty_cache()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_main(["--mode", "codist-shardmap", "--steps", "3", "--batch",
                    "2", "--seq", "16", "--log-every", "1", "--device",
                    dev.type])
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  cli: {line}")
    require(len(lines) == 4 and lines[-1].startswith("done: 3 steps")
            and "distill_loss=" in lines[0],
            f"shardmap: the CLI printed {lines}")
    return launches


# ----------------------------------------------------------------------------
# phase 20 (mesh) and on request (mesh4): the codist step on a (pod, data,
# model) mesh, every rank on its own card over NCCL
# ----------------------------------------------------------------------------

# qwen1.5-0.5b at full width cut to MESH_LAYERS of 24, fp32 (TF32 off), 2
# peers of MESH_B x MESH_S Markov tokens, SGD-momentum at a constant lr
MESH_ARCH, MESH_LAYERS = "qwen1.5-0.5b", 4
MESH_B, MESH_S, MESH_STEPS, MESH_LR = 2, 512, 3, 0.1
MESH_TOPK = 64
# mesh4's parity meshes (pod x FSDP, pod x TP) and its tolerance (the
# reference test's own bounds)
MESH4_PARITY = ((2, 2, 1), (2, 1, 2))
MESH4_TOL = 1e-4
# mesh4's configuration that needs the cards: deepseek-67b at full width and
# BIG_LAYERS of 95, bf16 over fp32 masters, AdamW, 2 peers on (2, 1, 2)
BIG_ARCH, BIG_LAYERS, BIG_B, BIG_S, BIG_MESH = "deepseek-67b", 4, 4, 512, \
    (2, 1, 2)
# mesh4's microbatched runs (k 2, both strategies) and the bound on their
# and the all-reduce baseline's losses against the single card (relative)
MESH4_K2 = (2, 2, 1)
MESH4_NEW_TOL = 1e-5
# mesh4's other families, codist on FAMILY_MESH in fp32 against the single
# card: rwkv6-1.6b at full width and depth (remat), internvl2-76b at full
# width and 2 of 80 layers with its 256 patches (plain SGD: both peers'
# fp32 weights and gradients, 61 GB, on the single card)
FAMILY_MESH4 = (("rwkv6-1.6b", 0), ("internvl2-76b", 2))
FAMILY_MESH = (2, 1, 2)
# mesh4's paper models at full size in fp32 (TF32 off), SGD-momentum, each
# held to the single card: (arch, rows a peer, target tokens, lr, frozen
# prefixes, codist meshes, all-reduce meshes). resnet50 2 x 16 images of
# 224^2, wrn28x10 2 x 128 of 32^2 with its stem and stage 0 frozen,
# transformer-big 2 x 14 x 256 source and target tokens, whisper-tiny 2 x 4
# x 64 target tokens over 1500 numpy frames; the baseline's one model takes
# both peers' rows
PAPER_MESH4 = (("resnet50", 16, 0, 1e-3, None, ((2, 2, 1),), ((2, 2, 1),)),
               ("wrn28x10", 128, 0, 1e-4, ("stem", "s0"), ((2, 2, 1),),
                ((2, 2, 1),)),
               ("transformer-big", 14, 256, 1e-2, None,
                ((2, 1, 2), (2, 2, 1)), ((2, 1, 2),)),
               ("whisper-tiny", 4, 64, 1e-2, None, ((2, 2, 1),), ()))
# transformer-big as it trains (bf16 over fp32 masters, AdamW), timed
PAPER_BF16 = ("transformer-big", 14, 256, (2, 1, 2))
# the paper's own models on the mesh phase's 1-rank mesh in fp32 (TF32
# off), one codist and one all-reduce step each at the paper phase's lr
# 1e-3: (arch, rows a peer, target tokens, overrides) of resnet50 at full
# size (8 images of 224^2 a peer) and transformer-big at full width and 2
# of its 6 encoder and 6 decoder layers (14 x 256 source and target tokens
# a peer)
MESH_PAPER = (("resnet50", 8, 0, {}),
              ("transformer-big", 14, 256, {"num_layers": 2,
                                            "encoder_layers": 2}))
MESH_PAPER_LR = 1e-3
# the mesh phase's hybrid MoE step: jamba at full width cut to 2 layers in
# reduced()'s pattern (Mamba + dense FFN, then attention + MoE; ~3.7 B
# parameters a model), every weight in bf16, plain SGD at lr 1e-3 (no
# buffer: both peers' weights and gradients are ~29 GB): (arch, layers,
# rows a peer, tokens); one step of each strategy, the placed one first
MESH_MOE = ("jamba-v0.1-52b", 2, 1, 512)
# mesh4's MoE and hybrid cases at full width, every weight in bf16, plain
# SGD at lr 1e-3, 2 peers of MOE4_B x MOE4_S tokens (the baseline's one
# model of both peers' rows): (label, arch, layers, strategy, mesh, expert
# axis). grok-1 at 2 of 64 layers (8 experts) with and without the expert
# axis (4 experts a rank, or FSDP inside each expert), arctic at 1 of 35
# (128 experts, 64 a rank, and the dense residual), jamba in MESH_MOE's
# 2-layer pattern (16 experts)
MOE4_B, MOE4_S = 2, 512
MOE4_CASES = (
    ("grok-1 codist fsdp", "grok-1-314b", 2, "codist", (2, 2, 1), None),
    ("grok-1 codist ep", "grok-1-314b", 2, "codist", (2, 2, 1), "data"),
    ("grok-1 allreduce ep", "grok-1-314b", 2, "allreduce", (2, 2, 1),
     "data"),
    ("arctic codist ep", "arctic-480b", 1, "codist", (2, 2, 1), "data"),
    ("jamba codist ep", "jamba-v0.1-52b", 2, "codist", (2, 2, 1), "data"),
    ("jamba codist tp", "jamba-v0.1-52b", 2, "codist", (2, 1, 2), None),
    ("jamba allreduce ep", "jamba-v0.1-52b", 2, "allreduce", (2, 2, 1),
     "data"))
# the two placements of grok-1's codist step against each other: bf16's
# unit roundoff, relative, on every loss of every step
MOE4_BF16_TOL = 2.0 ** -8
# mesh4's MoE parity in fp32 (TF32 off) against the single card, at a
# depth one card holds for the strategy: jamba's 2 layers as codist (both
# peers, ~59 GB of weights and gradients) and as the baseline, grok-1's
# baseline at 1 of 64 layers (one model, ~52 GB); grok-1's codist peers
# and arctic's one layer (~14 B parameters) exceed a card in fp32. Each
# recomputes its layers in the backward (remat), which bounds the Mamba
# scan's saved states to one layer's and runs each all-to-all a third time
MOE4_PARITY = (
    ("jamba codist ep fp32", "jamba-v0.1-52b", 2, "codist", (2, 2, 1),
     "data"),
    ("jamba allreduce ep fp32", "jamba-v0.1-52b", 2, "allreduce", (2, 2, 1),
     "data"),
    ("grok-1 allreduce ep fp32", "grok-1-314b", 1, "allreduce", (2, 2, 1),
     "data"))


def moe_mesh_cfg(arch: str, layers: int, dtype: str = "bfloat16"):
    """``get_config(arch)`` at ``layers`` layers (a hybrid in reduced()'s
    pattern: attention every 2nd layer), its activations and every weight
    in ``dtype``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    kw = {"attn_layer_period": 2} if cfg.attn_layer_period else {}
    return replace(cfg, num_layers=layers, dtype=dtype, param_dtype=dtype,
                   **kw)


def paper_mesh_cfg(arch: str, overrides: dict, dtype: str = "float32"):
    """``get_config(arch)`` with ``overrides``; an LM's activations in
    ``dtype`` (a conv net is fp32 throughout)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if hasattr(cfg, "kind"):
        return cfg
    return replace(cfg, dtype=dtype, **overrides)


def paper_mesh_data(cfg, b: int, s: int, steps: int, seed: int = 7) -> list:
    """``steps`` host batches of 2 peers' own rows (2, b, ...): a conv
    net's images of ``cfg.image_size``^2 and labels (``classification_batch``
    of a generator seeded by step and peer), an enc-dec LM's Markov tokens
    of ``mesh_data`` with numpy source tokens (s of them) or its
    ``num_audio_frames`` numpy frames."""
    from repro_torch.data import classification_batch
    from repro_torch.train import stack_batches
    if hasattr(cfg, "kind"):
        def one(k, g):
            gen = torch.Generator().manual_seed(seed * 1000 + 10 * k + g)
            return classification_batch(gen, b, 3072, cfg.num_classes,
                                        image=True,
                                        image_size=cfg.image_size)
        return [stack_batches([one(k, g) for g in range(2)])
                for k in range(steps)]
    out = mesh_data(cfg, b, s, steps, seed)
    rng = np.random.default_rng(seed)
    for batch in out:
        if cfg.num_audio_frames:
            batch["frames"] = torch.from_numpy((0.5 * rng.standard_normal(
                (2, b, cfg.num_audio_frames, cfg.d_model))).astype(
                    np.float32))
        else:
            batch["src_tokens"] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, b, s)).astype(np.int32))
    return out


def mesh_data(cfg, b: int, s: int, steps: int, seed: int = 7) -> list:
    """``steps`` host batches (2, b, s) of a Markov chain over 256 of the
    vocab (a task the peers learn within the steps)."""
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.train import stack_batches
    task = MarkovLM(vocab=cfg.vocab_size, seed=1, effective_vocab=256)
    return [stack_batches([make_lm_batch(task, b, s, k, g, seed=seed,
                                         device="cpu") for g in range(2)])
            for k in range(steps)]


def one_model(batches: list) -> list:
    """The all-reduce baseline's batches: each codist batch's (2, b, ...)
    rows as one model's (2 b, ...)."""
    return [{k: v.reshape(-1, *v.shape[2:]) for k, v in b.items()}
            for b in batches]


def micro(batches: list, k: int, lead: int) -> list:
    """Each leaf's batch dim (after ``lead`` leading axes) split into (k,
    B/k): the step's microbatched layout."""
    def one(v):
        return v.reshape(*v.shape[:lead], k, v.shape[lead] // k,
                         *v.shape[lead + 1:])
    return [{n: one(v) for n, v in b.items()} for b in batches]


def mesh_job(pods, label: str, cfg, codist, tc, batches, strategy,
             profile_rank0: bool = False, state=None,
             timed: bool = False, trainable=None) -> dict:
    """One mesh run through ``train`` (the state drawn from ``tc.seed`` on
    this rank's card, or ``state``, placed by the strategy), with the
    launch counts, the DTensor entry's calls and the optimizer's pod meter
    set to 0 just before and read just after; per step (from one step's
    start to the next's) the wall, the pod gather's seconds and, with
    ``timed``, the optimizer's cross-pod reduction's (each reduction
    between two device syncs); rank 0's steps 1.. under torch.profiler
    where asked (``device_ms``: their kernels' device time); the expert
    all-to-all's meter (``a2a_bytes``, ``a2a``) likewise. ``trainable``
    is the step's mask (``freeze_mask``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import local_rows_calls
    from repro_torch.launch.mesh import expert_exchange
    from repro_torch.models import build_model
    from repro_torch.optim import optimizers
    from repro_torch.train import train
    dev = pods.device
    model = build_model(cfg)
    marks: list = []
    meter = optimizers.pod_sync

    prof = (profile(activities=[ProfilerActivity.CUDA])
            if profile_rank0 and dist_rank() == 0 else None)

    def data(k):
        if k == 1 and prof is not None:
            sync(dev)          # steps 1.. (after the init and step 0)
            prof.__enter__()
        marks.append((time.perf_counter(), pods.wire_s, meter.seconds))
        return batches[k]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    bytes0 = pods.wire_bytes
    reset_launch_counts()
    for k in local_rows_calls:
        local_rows_calls[k] = 0
    meter.reset()
    meter.timed = timed
    expert_exchange.reset()
    t0 = time.perf_counter()
    try:
        state, hist = train(model, tc, data, strategy, codist=codist,
                            log_every=1, state=state, trainable=trainable,
                            device=dev)
    finally:
        meter.timed = False
    sync(dev)
    marks.append((time.perf_counter(), pods.wire_s, meter.seconds))
    device_ms = None
    if prof is not None:
        prof.__exit__(None, None, None)
        us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages()
                 if getattr(e, "device_type", None)
                 == torch.autograd.DeviceType.CUDA)
        device_ms = us / 1e3 if us > 0 else None
    return {"label": label, "state": state,
            "records": finite_records(hist, f"{label} rank {dist_rank()}"),
            "seconds": time.perf_counter() - t0,
            "step_s": [b[0] - a[0] for a, b in zip(marks, marks[1:])],
            "wire_s": [b[1] - a[1] for a, b in zip(marks, marks[1:])],
            "pod_s": [b[2] - a[2] for a, b in zip(marks, marks[1:])],
            "wire_bytes": pods.wire_bytes - bytes0,
            "pod_bytes": meter.bytes, "pod_reductions": meter.reductions,
            "a2a_bytes": expert_exchange.bytes,
            "a2a": expert_exchange.exchanges,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "launches": dict(launch_counts), "entry": dict(local_rows_calls),
            "device_ms": device_ms}


def dist_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def shard_errors(placed, plain, sub_mesh) -> tuple:
    """(worst absolute, worst relative to the leaf's largest value, the
    leaf of the worst relative) error of this rank's local shards of the
    ``placed`` leaves against the same shards of the ``plain`` single-card
    leaves."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.sharding import tree_flatten_with_path
    worst_abs = worst_rel = 0.0
    where = None
    for (path, a), (_p, b) in zip(tree_flatten_with_path(placed),
                                  tree_flatten_with_path(plain)):
        want = distribute_tensor(b.detach(), sub_mesh, a.placements,
                                 src_data_rank=None).to_local()
        err = float((a.to_local().detach().float() - want.float())
                    .abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        worst_abs = max(worst_abs, err)
        if rel >= worst_rel:
            worst_rel, where = rel, path
    return worst_abs, worst_rel, where


def mesh_tc(**kw):
    from repro_torch.configs import TrainConfig
    return TrainConfig(**{**dict(lr=MESH_LR, lr_schedule="constant",
                                 warmup_steps=0, total_steps=MESH_STEPS,
                                 optimizer="sgdm"), **kw})


def placed_pe(mesh, pods):
    """``PredictionExchange`` whose drawn state and batches (microbatched
    ones too) are placed on this pod's devices, both peers on them."""
    from repro_torch.launch import sharding as sh
    from repro_torch.train import PredictionExchange

    class Placed(PredictionExchange):
        def ensure_state(self, state, model, tc, example_batch=None):
            return sh.distribute_state(state, mesh, pods.sub_mesh, 2)

        def init_state(self, model, tc, generator, opt_init,
                       example_batch=None, device="cuda"):
            return self.ensure_state(super().init_state(
                model, tc, generator, opt_init, example_batch, device),
                model, tc)

        def prepare(self, state, batch_all, k):
            return super().prepare(state, sh.distribute_batch(
                batch_all, mesh, pods.sub_mesh, microbatched=k > 1), k)
    return Placed


def mesh_smoke_rank(pods) -> dict:
    """The mesh phase's one rank (a (1, 1, 1) mesh, NCCL on card 0):
    qwen1.5-0.5b at MESH_LAYERS in fp32 (TF32 off). Both peers DTensors on
    the pod's (data, model) devices (the pod axis is not 2, so the peer
    axis stays unplaced), ``PredictionExchange`` over them against the
    plain step from the same weights and batches; one model over the whole
    mesh, ``AllReduce``, against the plain ``AllReduce``; then one step of
    2 microbatches of each against its plain step; then one step of each
    strategy of the paper's models (MESH_PAPER) against its plain step."""
    from repro_torch.configs import CodistConfig, get_config
    from repro_torch.launch.mesh import logical_mesh
    from repro_torch.train import AllReduce, PredictionExchange
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's default convolution backward may sum in any order (a weight
    # gradient 3e-8 apart between two runs of one step): the bit-equality
    # of the conv steps needs its deterministic algorithms
    torch.backends.cudnn.deterministic = True
    cfg = replace(get_config(MESH_ARCH), num_layers=MESH_LAYERS,
                  dtype="float32")
    codist = CodistConfig(n_models=2)
    batches = mesh_data(cfg, MESH_B, MESH_S, MESH_STEPS)
    Placed = placed_pe(logical_mesh(pods.mesh), pods)
    out = {}

    def pair(name, codist, tc, batches, plain, placed, mesh, cfg=cfg,
             draw=None):
        """The plain run, then the placed one, each drawn from
        ``tc.seed``; with ``draw`` the placed run first, then the plain
        one, each from ``draw()`` (the same weights)."""
        if draw is None:
            a = mesh_job(pods, f"mesh {name} plain", cfg, codist, tc,
                         batches, plain)
        b = mesh_job(pods, f"mesh {name}", cfg, codist, tc, batches, placed,
                     state=None if draw is None else draw())
        if draw is not None:
            a = mesh_job(pods, f"mesh {name} plain", cfg, codist, tc,
                         batches, plain, state=draw())
        err = shard_errors(b["state"].params, a["state"].params, mesh)
        for run in (a, b):
            del run["state"]
        out[name] = {"plain": a, "placed": b, "leaf_err": err}
    pair("codist", codist, mesh_tc(), batches, PredictionExchange(codist),
         Placed(codist), pods.sub_mesh)
    pair("allreduce", None, mesh_tc(), one_model(batches), AllReduce(),
         AllReduce(mesh=pods), pods.mesh)
    k2 = mesh_tc(microbatch=2, total_steps=1)
    pair("allreduce k2", None, k2, micro(one_model(batches[:1]), 2, 0),
         AllReduce(), AllReduce(mesh=pods), pods.mesh)
    pair("codist k2", codist, k2, micro(batches[:1], 2, 1),
         PredictionExchange(codist), Placed(codist), pods.sub_mesh)
    one = mesh_tc(lr=MESH_PAPER_LR, total_steps=1)
    for arch, b, s, kw in MESH_PAPER:
        pcfg = paper_mesh_cfg(arch, kw)
        data = paper_mesh_data(pcfg, b, s, 1)
        pair(f"{arch} codist", codist, one, data, PredictionExchange(codist),
             Placed(codist), pods.sub_mesh, pcfg)
        pair(f"{arch} allreduce", None, one, one_model(data), AllReduce(),
             AllReduce(mesh=pods), pods.mesh, pcfg)
    arch, layers, b, s = MESH_MOE
    mcfg = moe_mesh_cfg(arch, layers)
    sgd = mesh_tc(lr=1e-3, momentum=0.0, total_steps=1)
    draw = plain_sgd_draw(mcfg, sgd, pods.device)
    data = mesh_data(mcfg, b, s, 1)
    pair(f"{arch} codist", codist, sgd, data, PredictionExchange(codist),
         Placed(codist), pods.sub_mesh, mcfg, draw=lambda: draw(None))
    pair(f"{arch} allreduce", None, sgd, one_model(data), AllReduce(),
         AllReduce(mesh=pods), pods.mesh, mcfg, draw=lambda: draw(0))
    return out


# the mesh phase's runs: (name, steps, combined loss rows, DTensor entry,
# loss-row launches a step, bound on the relative difference to the plain
# step: 0 is bit-equal)
MESH_RUNS = (("codist", MESH_STEPS, True, "_CEDistillTokens", 2, 1e-6),
             ("allreduce", MESH_STEPS, False, "_CEParts", 1, 0.0),
             ("allreduce k2", 1, False, "_CEParts", 2, 1e-6),
             ("codist k2", 1, True, "_CEDistillTokens", 4, 1e-6),
             ("resnet50 codist", 1, True, "_CEDistillTokens", 2, 0.0),
             ("resnet50 allreduce", 1, False, "_CEParts", 1, 0.0),
             ("transformer-big codist", 1, True, "_CEDistillTokens", 2, 0.0),
             ("transformer-big allreduce", 1, False, "_CEParts", 1, 0.0),
             (f"{MESH_MOE[0]} codist", 1, True, "_CEDistillTokens", 2, 0.0),
             (f"{MESH_MOE[0]} allreduce", 1, False, "_CEParts", 1, 0.0))


def mesh_run_what(name: str, combined: bool, per_step: int,
                  steps: int) -> str:
    """What a mesh phase run trained, for its log line."""
    peers = "2 peers of" if combined else "one model of"
    arch, layers, b, s = MESH_MOE
    if name.startswith(arch):
        return (f"{arch} {layers} of 32 layers (Mamba + dense FFN, attention "
                f"+ 16-expert MoE) bf16, plain SGD, {peers} "
                f"{b if combined else 2 * b} x {s}, lr 1e-3, 1 step (the "
                "placed step first)")
    for arch, b, s, kw in MESH_PAPER:
        if name.startswith(arch):
            rows = b if combined else 2 * b
            side = paper_mesh_cfg(arch, kw).image_size if not s else 0
            size = (f"{rows} images of {side}^2" if not s else
                    f"{rows} x {s} tokens ({kw['num_layers']} of 6 layers "
                    "a stack)")
            return f"{arch} fp32, {peers} {size}, lr {MESH_PAPER_LR:g}, 1 step"
    rows = MESH_B if combined else 2 * MESH_B
    return (f"{MESH_ARCH} {MESH_LAYERS} of 24 layers fp32, {peers} {rows} x "
            f"{MESH_S}, {steps} step(s) of "
            f"{per_step // (2 if combined else 1)} microbatch(es)")


def phase_mesh(dev: torch.device) -> dict:
    """The codist and all-reduce steps over DTensors on one card (module
    docstring, phase 20): a 1-rank NCCL mesh (1, 1, 1). Both peers placed
    on it, ``PredictionExchange`` 3 steps against the plain step on the
    same card from the same weights and Markov batches: losses and every
    leaf within 1e-6 relative, rows 12 and 13 launched once a peer a step.
    One model over it, ``AllReduce`` 3 steps: losses and every leaf
    bit-equal to the plain step's, rows 6 and 7 once a step. One step of 2
    microbatches of each: within 1e-6, the rows once a microbatch (a peer).
    Every launch through the loss kernels' DTensor entry. Returns the
    placed runs' launches."""
    from repro_torch.launch.mesh import make_codist_mesh, spawn_pods
    t0 = time.perf_counter()
    (out,) = spawn_pods(mesh_smoke_rank, 1, (), device=str(dev),
                        timeout_s=600.0, mesh=make_codist_mesh(1, 1, 1))
    total = dict.fromkeys(ALL_LOSS_KERNELS, 0)
    for name, steps, combined, entry, per_step, tol in MESH_RUNS:
        plain, placed = out[name]["plain"], out[name]["placed"]
        want = expected_launches(per_step, "mse", steps, combined=combined,
                                 task_ce=not combined, standalone=0)
        got = {k: placed["launches"][k] for k in ALL_LOSS_KERNELS}
        require(got == want, f"mesh {name}: launches {got} != {want}")
        calls = placed["entry"]
        require(calls[entry] == steps * per_step
                and sum(calls.values()) == calls[entry],
                f"mesh {name}: DTensor entry calls {calls} for launches "
                f"{got}")
        for k, v in got.items():
            total[k] += v
        worst = 0.0
        for a, b in zip(plain["records"], placed["records"]):
            for m in ("loss", "task_loss", "distill_loss"):
                if m not in a:
                    continue
                rel = abs(b[m] - a[m]) / max(abs(a[m]), 1e-12)
                worst = max(worst, rel)
                require(rel <= tol, f"mesh {name} step {a['step']} {m}: "
                        f"{b[m]} vs the plain step's {a[m]}")
        err = out[name]["leaf_err"]
        require(err[1] <= tol, f"mesh {name}: a leaf differs from the "
                f"plain step's by {err} (absolute, relative, leaf)")
        moved = abs(plain["records"][-1]["loss"] - plain["records"][0]["loss"])
        wall = [x * 1e3 for x in placed["step_s"][1:] or placed["step_s"]]
        log(f"mesh {name}: {mesh_run_what(name, combined, per_step, steps)}"
            " on a (1, 1, 1) NCCL mesh: losses "
            f"{[round(r['loss'], 6) for r in placed['records']]} (moved "
            f"{moved:.4f}), within {worst:.2e} relative of the plain step "
            f"({'' if worst == 0 and err[0] == 0 else 'not '}bit-equal"
            f"), leaves within {err[0]:.2e} absolute ({err[1]:.2e} relative, "
            f"at {err[2]}); launches {({k: v for k, v in got.items() if v})}, "
            f"all through the DTensor entry ({calls}); wall a step "
            + ", ".join(f"{w:.1f}" for w in wall)
            + (" ms placed (with the init), " if steps == 1
               else " ms placed, ")
            + ", ".join(f"{x * 1e3:.1f}" for x in
                        plain["step_s"][1:] or plain["step_s"])
            + f" ms plain; peak {placed['peak_bytes'] / 2**30:.2f} GiB")
    log(f"mesh: {time.perf_counter() - t0:.1f} s with the spawn")
    return total


def big_peer_bytes(cfg) -> tuple:
    """(parameters of one peer, bytes of its fp32 master, gradient and two
    AdamW moments: 16 a parameter)."""
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves
    n = sum(x.numel() for x in tree_leaves(build_model(cfg).init(
        None, device="meta")))
    return n, 16 * n


def mesh4_rank(pods) -> dict:
    """One of mesh4's 4 ranks (cuda:rank, NCCL). First the parity jobs:
    on each mesh of MESH4_PARITY and over the none and top-64 wires,
    qwen1.5-0.5b at MESH_LAYERS in fp32 (TF32 off) trains 3 steps of
    ``ShardMapCompressed`` (this rank's pod's peer placed by the rules)
    and, on this rank's card, the single-card ``PredictionExchange`` from
    the same weights and batches, whose final leaves this rank's shards
    are held to. Then deepseek-67b at BIG_LAYERS, bf16 over fp32 masters,
    AdamW, 2 peers on BIG_MESH, the none wire, rank 0 under
    torch.profiler."""
    from repro_torch.configs import CodistConfig, get_config
    from repro_torch.launch.mesh import (device_mesh, make_codist_mesh,
                                         mesh_pod_group)
    from repro_torch.models import build_model
    from repro_torch.models.conv import freeze_mask
    from repro_torch.train import (AllReduce, PredictionExchange,
                                   ShardMapCompressed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    groups = {MESH4_PARITY[0]: pods}
    for shape in MESH4_PARITY[1:] + (BIG_MESH, MESH4_K2, FAMILY_MESH) + tuple(
            m for case in PAPER_MESH4 for m in case[5] + case[6]):
        if shape not in groups:
            m = make_codist_mesh(*shape)
            groups[shape] = mesh_pod_group(
                m, device_mesh(m, pods.device.type), pods.device)
    cfg = replace(get_config(MESH_ARCH), num_layers=MESH_LAYERS,
                  dtype="float32")
    batches = mesh_data(cfg, MESH_B, MESH_S, MESH_STEPS)
    out = {"parity": []}
    for wire in ("none", "topk"):
        codist = CodistConfig(n_models=2, compression=wire, topk=MESH_TOPK)
        plain = mesh_job(pods, f"mesh4 plain {wire}", cfg, codist, mesh_tc(),
                         batches, PredictionExchange(codist))
        for shape in MESH4_PARITY:
            g = groups[shape]
            run = mesh_job(g, f"mesh4 {shape} {wire}", cfg, codist,
                           mesh_tc(), batches, ShardMapCompressed(codist, g))
            run["leaf_err"] = shard_errors(run["state"].params,
                                           plain["state"].params[g.rank],
                                           g.sub_mesh)
            del run["state"]
            run.update(shape=shape, wire=wire, pod=g.rank)
            out["parity"].append(run)
        del plain["state"]
        out["parity"].append({**plain, "shape": None, "wire": wire})
    codist = CodistConfig(n_models=2)
    out["held"] = []

    def held(name, cfg_, codist_, tc, data, plain_strategy, placed, shapes,
             draw=None, trainable=None, profile=False):
        """``placed(g)`` on each mesh of ``shapes`` held to
        ``plain_strategy`` on this rank's card (``draw(i)``: the plain
        state (i None) or pod i's peer's, plain SGD; else drawn from
        ``tc.seed`` by the strategies), both with the mask ``trainable``;
        with ``profile`` rank 0's runs under torch.profiler and the
        baseline's cross-pod reduction timed. Each run keeps the rows and
        positions of its step for the cost model."""
        one = codist_ is None
        labels = data[0]["labels"]
        lm = not hasattr(cfg_, "kind")
        rows = labels.numel() // (labels.shape[-1] if lm else 1)
        seq = labels.shape[-1] + cfg_.num_patches if lm else 1
        plain = mesh_job(pods, f"mesh4 {name} plain", cfg_, codist_, tc,
                         data, plain_strategy,
                         state=None if draw is None else draw(None),
                         trainable=trainable, profile_rank0=profile)
        for shape in shapes:
            g = groups[shape]
            run = mesh_job(g, f"mesh4 {name} {shape}", cfg_, codist_, tc,
                           data, placed(g),
                           state=None if draw is None else draw(g.rank),
                           trainable=trainable, profile_rank0=profile,
                           timed=profile and one)
            run["leaf_err"] = shard_errors(
                run["state"].params,
                plain["state"].params if one else
                plain["state"].params[g.rank],
                g.mesh if one else g.sub_mesh)
            del run["state"]
            run.update(name=name, shape=shape, pod=g.rank, cfg=cfg_,
                       plain=plain["records"], rows=rows, seq=seq,
                       plain_run={k: plain[k] for k in (
                           "step_s", "device_ms", "peak_bytes")})
            out["held"].append(run)
        del plain["state"]
        torch.cuda.empty_cache()

    held("allreduce", cfg, None, mesh_tc(), one_model(batches), AllReduce(),
         lambda g: AllReduce(mesh=g), MESH4_PARITY)
    # 2 microbatches of twice the rows: each splits over pod x data (one
    # model) or over data (a peer), as the step's batch does
    k2, wide = mesh_tc(microbatch=2), mesh_data(cfg, 2 * MESH_B, MESH_S,
                                                MESH_STEPS)
    held("allreduce k2", cfg, None, k2, micro(one_model(wide), 2, 0),
         AllReduce(), lambda g: AllReduce(mesh=g), (MESH4_K2,))
    held("codist k2", cfg, codist, k2, micro(wide, 2, 1),
         PredictionExchange(codist), lambda g: ShardMapCompressed(codist, g),
         (MESH4_K2,))
    big = replace(get_config(BIG_ARCH), num_layers=BIG_LAYERS)
    g = groups[BIG_MESH]
    big_tc = mesh_tc(optimizer="adamw", lr=1e-4, lr_schedule="constant")
    big_data = mesh_data(big, BIG_B, BIG_S, MESH_STEPS)
    run = mesh_job(g, "mesh4 deepseek", big, codist, big_tc, big_data,
                   ShardMapCompressed(codist, g), profile_rank0=True)
    del run["state"]
    run.update(pod=g.rank)
    out["big"] = run
    run = mesh_job(g, "mesh4 deepseek allreduce", big, None, big_tc,
                   one_model(big_data), AllReduce(mesh=g),
                   profile_rank0=True, timed=True)
    del run["state"]
    out["big_ar"] = run
    for arch, layers in FAMILY_MESH4:
        fcfg = replace(get_config(arch), dtype="float32",
                       **({"num_layers": layers} if layers else {}))
        data = mesh_data(fcfg, MESH_B, MESH_S, MESH_STEPS)
        if fcfg.num_patches:
            rng = np.random.default_rng(11)
            for b in data:
                b["patches"] = torch.from_numpy((0.1 * rng.standard_normal(
                    (2, MESH_B, fcfg.num_patches, fcfg.d_model))).astype(
                        np.float32))
        draw = None
        tc = mesh_tc(lr=0.01, remat=fcfg.family == "ssm")
        if fcfg.num_patches:       # plain SGD: both peers fit on one card
            tc = mesh_tc(lr=0.01, momentum=0.0)
            draw = plain_sgd_draw(fcfg, tc, pods.device)
        held(arch, fcfg, codist, tc, data, PredictionExchange(codist),
             lambda g: ShardMapCompressed(codist, g), (FAMILY_MESH,), draw)
    for arch, b, s, lr, frozen, cd_meshes, ar_meshes in PAPER_MESH4:
        pcfg = paper_mesh_cfg(arch, {})
        data = paper_mesh_data(pcfg, b, s, MESH_STEPS)
        tc = mesh_tc(lr=lr)
        mask = None if frozen is None else freeze_mask(
            build_model(pcfg).init(None, device="meta"), frozen)
        held(f"{arch} codist", pcfg, codist, tc, data,
             PredictionExchange(codist), lambda g: ShardMapCompressed(codist, g),
             cd_meshes, trainable=mask, profile=True)
        if ar_meshes:
            held(f"{arch} allreduce", pcfg, None, tc, one_model(data),
                 AllReduce(), lambda g: AllReduce(mesh=g), ar_meshes,
                 trainable=mask, profile=True)
    # transformer-big as it trains: bf16 activations over fp32 masters,
    # AdamW, both strategies on PAPER_BF16's mesh, timed (not held)
    arch, b, s, shape = PAPER_BF16
    pcfg = paper_mesh_cfg(arch, {}, dtype=get_config(arch).dtype)
    data = paper_mesh_data(pcfg, b, s, MESH_STEPS)
    adam = mesh_tc(optimizer="adamw", lr=1e-4)
    g = groups[shape]
    out["paper_bf16"] = {}
    for mode, cd_, d, strategy in (
            ("codist", codist, data, ShardMapCompressed(codist, g)),
            ("allreduce", None, one_model(data), AllReduce(mesh=g))):
        run = mesh_job(g, f"mesh4 {arch} bf16 {mode}", pcfg, cd_, adam, d,
                       strategy, profile_rank0=True, timed=cd_ is None)
        del run["state"]
        run.update(pod=g.rank, cfg=pcfg, shape=shape,
                   rows=d[0]["labels"].numel() // s, seq=s)
        out["paper_bf16"][mode] = run
        torch.cuda.empty_cache()
    return out


def plain_sgd_draw(cfg, tc, dev):
    """``draw(i)``: the codist state of both peers (i None) or pod i's
    peer's ``TrainState``, drawn as the strategies draw them from
    ``tc.seed`` on ``dev``, with plain SGD's empty optimizer state (no
    buffer: the two peers' fp32 weights and gradients then fit one card)."""
    from repro_torch.models import build_model
    from repro_torch.optim import OptState
    from repro_torch.train.state import (CodistState, TrainState,
                                         trainable_params)
    model = build_model(cfg)

    def draw(i):
        gen = torch.Generator(device=dev)
        gen.manual_seed(tc.seed)
        if i is None:
            peers = [trainable_params(model.init(gen, device=dev))
                     for _ in range(2)]
            return CodistState(peers, OptState(0, None, None), 0)
        for _ in range(i):
            model.init(gen, device=dev)
        return TrainState(trainable_params(model.init(gen, device=dev)),
                          OptState(0, None, None), 0)
    return draw


def mesh4_moe_rank(pods) -> dict:
    """One of mesh4's 4 ranks for the MoE and hybrid cases (cuda:rank,
    NCCL): each of MOE4_CASES 3 steps in bf16 (``ShardMapCompressed`` of
    this rank's pod's peer, or ``AllReduce`` of the one model, placed with
    the case's expert axis), rank 0 under torch.profiler; then each of
    MOE4_PARITY in fp32 (TF32 off), held to the single-card step on this
    rank's card from the same draw."""
    from repro_torch.configs import CodistConfig
    from repro_torch.launch.mesh import (device_mesh, make_codist_mesh,
                                         mesh_pod_group)
    from repro_torch.train import (AllReduce, PredictionExchange,
                                   ShardMapCompressed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    groups = {}
    for case in MOE4_CASES + MOE4_PARITY:
        shape = case[4]
        if shape not in groups:
            m = make_codist_mesh(*shape)
            groups[shape] = mesh_pod_group(
                m, device_mesh(m, pods.device.type), pods.device)
    codist = CodistConfig(n_models=2)
    out = {"runs": [], "parity": []}

    def placed(label, cfg, mode, shape, ep, data, draw, profile, tc):
        g = groups[shape]
        one = mode == "allreduce"
        strategy = (AllReduce(mesh=g, moe_expert_axis=ep) if one else
                    ShardMapCompressed(codist, g, moe_expert_axis=ep))
        # placed before the run, so that the drawn whole model is freed
        # (grok-1's fp32 one is 26 GB) before its step's gradients exist
        state = strategy.ensure_state(draw(0 if one else g.rank), None, tc)
        run = mesh_job(g, f"mesh4 {label}", cfg, None if one else codist,
                       tc, one_model(data) if one else data, strategy,
                       state=state, profile_rank0=profile,
                       timed=profile and one)
        del state
        run.update(label=label, cfg=cfg, mode=mode, shape=shape, ep=ep,
                   pod=g.rank, remat=tc.remat)
        if dist_rank() == 0:
            log(f"mesh4 {label}: rank 0 ran {run['seconds']:.1f} s, peak "
                f"{run['peak_bytes'] / 2**30:.2f} GiB")
        return g, run

    for label, arch, layers, mode, shape, ep in MOE4_CASES:
        cfg = moe_mesh_cfg(arch, layers)
        data = mesh_data(cfg, MOE4_B, MOE4_S, MESH_STEPS)
        tc = mesh_tc(lr=1e-3, momentum=0.0)
        _g, run = placed(label, cfg, mode, shape, ep, data,
                         plain_sgd_draw(cfg, tc, pods.device), True, tc)
        del run["state"]
        out["runs"].append(run)
        torch.cuda.empty_cache()
    for label, arch, layers, mode, shape, ep in MOE4_PARITY:
        cfg = moe_mesh_cfg(arch, layers, "float32")
        data = mesh_data(cfg, MOE4_B, MOE4_S, MESH_STEPS)
        tc = mesh_tc(lr=1e-3, momentum=0.0, remat=True)
        draw = plain_sgd_draw(cfg, tc, pods.device)
        one = mode == "allreduce"
        plain = mesh_job(pods, f"mesh4 {label} plain", cfg,
                         None if one else codist, tc,
                         one_model(data) if one else data,
                         AllReduce() if one else PredictionExchange(codist),
                         state=draw(0 if one else None))
        g, run = placed(label, cfg, mode, shape, ep, data, draw, False, tc)
        run["leaf_err"] = shard_errors(
            run["state"].params, plain["state"].params if one else
            plain["state"].params[g.rank], g.mesh if one else g.sub_mesh)
        del run["state"], plain["state"]
        run["plain"] = plain["records"]
        out["parity"].append(run)
        torch.cuda.empty_cache()
    return out


def moe_cost(cfg, mode: str, shape, ep, remat: bool = False,
             steps: int = MESH_STEPS) -> tuple:
    """(all-to-all bytes, cross-pod bytes) a device of ``steps`` steps of
    ``mode`` on the mesh ``shape`` with the expert axis ``ep`` (and
    ``remat``), 2 peers of MOE4_B x MOE4_S tokens (the baseline's one
    model of both), by ``launch/cost.py``."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.cost import step_cost
    from repro_torch.launch.mesh import make_codist_mesh
    ops = step_cost(cfg, InputShape("mesh4", MOE4_S, 2 * MOE4_B, "train"),
                    mode, remat=remat, mesh=make_codist_mesh(*shape),
                    variant={"moe_expert_axis": ep},
                    codist_extra={"compression": "none"}).collectives
    a2a = sum(o.operand_bytes for o in ops.ops if o.kind == "all-to-all")
    return steps * a2a, steps * ops.cross_pod_bytes


def mesh4_moe_checks(ranks: list, smi_line: str) -> dict:
    """``phase_mesh4_moe``'s checks of its ranks' results: every run's
    losses finite and moving, launches exact through the DTensor entry
    (rows 12 and 13 a peer a step over the none wire, 6 and 7 the
    baseline's), each rank's metered all-to-all bytes (zero without the
    expert axis) and cross-pod bytes equal to ``launch/cost.py``'s; grok-1's
    two codist placements within MOE4_BF16_TOL of each other; the fp32
    parity runs within MESH4_NEW_TOL (losses, relative) and MESH4_TOL
    (shards, absolute) of the single card. Returns the launches."""
    from repro_torch.configs import get_config
    launches = dict.fromkeys(ALL_LOSS_KERNELS, 0)
    by_label = {}
    for j, job in enumerate(ranks[0]["runs"] + ranks[0]["parity"]):
        runs = [(r["runs"] + r["parity"])[j] for r in ranks]
        label, mode, cfg = job["label"], job["mode"], job["cfg"]
        one = mode == "allreduce"
        want = expected_launches(1, "mse", MESH_STEPS, combined=not one,
                                 task_ce=one, standalone=0)
        entry = "_CEParts" if one else "_CEDistillTokens"
        a2a, pod_b = moe_cost(cfg, mode, job["shape"], job["ep"],
                              job["remat"])
        for r, run in enumerate(runs):
            recs = run["records"]
            require(len(recs) == MESH_STEPS and recs[-1]["loss"]
                    != recs[0]["loss"], f"mesh4 {label} rank {r}: losses "
                    f"{[x['loss'] for x in recs]}")
            require(all(x["aux_loss"] > 0 for x in recs),
                    f"mesh4 {label} rank {r}: aux losses "
                    f"{[x['aux_loss'] for x in recs]}")
            got = {k: run["launches"][k] for k in ALL_LOSS_KERNELS}
            require(got == want, f"mesh4 {label} rank {r}: launches {got}")
            require(run["entry"][entry] == MESH_STEPS
                    and sum(run["entry"].values()) == MESH_STEPS,
                    f"mesh4 {label} rank {r}: DTensor entry {run['entry']}")
            for k, v in got.items():
                launches[k] += v
            require(run["a2a_bytes"] == a2a, f"mesh4 {label} rank {r}: "
                    f"metered {run['a2a_bytes']} all-to-all bytes, the cost "
                    f"model {a2a}")
            metered = run["pod_bytes"] if one else run["wire_bytes"]
            require(metered == pod_b, f"mesh4 {label} rank {r}: metered "
                    f"{metered} cross-pod bytes, the cost model {pod_b}")
        worst = 0.0
        for r, run in enumerate(runs):
            for a, b in zip(run.get("plain", ()), run["records"]):
                for m in ("loss", "task_loss", "distill_loss", "aux_loss"):
                    if m not in a:
                        continue
                    # the single card's PredictionExchange logs its codist
                    # loss without the aux term, the placed step with it
                    want_m = a[m] + (a["aux_loss"] if m == "loss" and not one
                                     else 0.0)
                    rel = abs(b[m] - want_m) / max(abs(want_m), 1e-12)
                    worst = max(worst, rel)
                    require(rel <= MESH4_NEW_TOL, f"mesh4 {label} rank {r} "
                            f"step {a['step']} {m}: {b[m]} vs the single "
                            f"card's {want_m}")
            if "leaf_err" in run:
                require(run["leaf_err"][0] <= MESH4_TOL, f"mesh4 {label} "
                        f"rank {r}: a leaf differs by {run['leaf_err']}")
        by_label[label] = runs
        r0 = runs[0]
        dev = r0["device_ms"]
        log(f"mesh4 {label}: {cfg.name} {cfg.num_layers} of "
            f"{get_config(cfg.name).num_layers} layers at full width, "
            f"{'fp32' if cfg.dtype == 'float32' else 'bf16'}, plain SGD, "
            + (f"one model of {2 * MOE4_B} x {MOE4_S}" if one else
               f"2 peers of {MOE4_B} x {MOE4_S}")
            + f" on {job['shape']}, experts over {job['ep'] or 'no axis'}"
            + (", remat" if job["remat"] else "") + ": "
            f"losses {[round(x['loss'], 5) for x in r0['records']]}"
            + (f" within {worst:.2e} relative of the single card (tol "
               f"{MESH4_NEW_TOL:g}), leaves within "
               f"{max(run['leaf_err'][0] for run in runs):.2e} absolute"
               if "plain" in r0 else "")
            + f"; wall a step {mean_ms(r0['step_s']):.1f} ms"
            + (f", device {dev / (MESH_STEPS - 1):.1f} ms" if dev else "")
            + f" (rank 0, steps 1-2); all-to-all {a2a // MESH_STEPS} bytes a "
            f"rank a step ({r0['a2a'] // MESH_STEPS} exchanges), cross-pod "
            f"{pod_b // MESH_STEPS} ({'gradient reduction over pod' if one else 'pod gather of the bf16 wire' if cfg.dtype != 'float32' else 'pod gather'}), "
            "both == launch/cost.py's; peak a rank "
            + ", ".join(f"{run['peak_bytes'] / 2**30:.2f}" for run in runs)
            + f" GiB; {smi_line}")
    fsdp, ep = by_label["grok-1 codist fsdp"], by_label["grok-1 codist ep"]
    worst = 0.0
    for a_run, b_run in zip(fsdp, ep):
        for a, b in zip(a_run["records"], b_run["records"]):
            for m in ("loss", "task_loss", "distill_loss", "aux_loss"):
                rel = abs(b[m] - a[m]) / max(abs(a[m]), 1e-12)
                worst = max(worst, rel)
                require(rel <= MOE4_BF16_TOL, f"mesh4 grok-1: step "
                        f"{a['step']} {m} {b[m]} with the expert axis, "
                        f"{a[m]} without (tol {MOE4_BF16_TOL:g})")
    log(f"mesh4 grok-1 codist: the expert axis and FSDP inside each expert "
        f"agree within {worst:.2e} relative on every loss of every step "
        f"(bf16's unit roundoff {MOE4_BF16_TOL:.2e})")
    return launches


def phase_mesh4_moe(dev: torch.device, smi_line: str) -> dict:
    """mesh4's MoE and hybrid cases alone, on a host with 4 cards: one
    spawn of 4 ranks (``mesh4_moe_rank``), their checks
    (``mesh4_moe_checks``). Returns the runs' launches."""
    from repro_torch.launch.mesh import make_codist_mesh, spawn_pods
    have = torch.cuda.device_count()
    require(have >= 4, f"mesh4 needs 4 cards, one a rank; this host has "
            f"{have}")
    t0 = time.perf_counter()
    # the fp32 parity runs hold both jamba peers' weights and gradients
    # (~59 GB) on one card: the ranks' allocator maps its blocks in
    # expandable segments, so that freed blocks stay usable (with fixed
    # ones 11 GiB sat reserved but unallocated when the backward ran out)
    before = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = spawn_pods(mesh4_moe_rank, 4, (), device=str(dev),
                           timeout_s=1500.0, mesh=make_codist_mesh(2, 2, 1))
    finally:
        if before is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = before
    log(f"mesh4 moe: 4 ranks on 4 cards, {time.perf_counter() - t0:.1f} s "
        "with the spawn")
    return mesh4_moe_checks(ranks, smi_line)


def phase_mesh4(dev: torch.device, smi_line: str) -> dict:
    """On request, on a host with 4 cards: one spawn of 4 ranks,
    one card each, NCCL (``mesh4_rank``). Parity: each rank's losses
    within MESH4_TOL relative of the single-card PredictionExchange, its
    shards of every leaf within MESH4_TOL absolute, the loss moving by more
    than 100 times that over the 3 steps; launches exact (rows 12 and 13
    over the none wire, 6 and 7 over top-64, one a rank a step, each
    through the DTensor entry); the pod gathers' bytes (each shard once a
    pod) equal to ``comm_bytes``. deepseek-67b: finite, moving losses,
    wall and device ms a step on rank 0, the pod gather's share of a
    step and each rank's bytes against ``launch/cost.py``'s (the bf16
    wire; the History's ``comm_bytes`` prices fp32 logits), each rank's
    peak memory beside the bytes of the two peers' training state.
    Then ``mesh4_baseline``'s runs (``run_phases`` then runs
    ``phase_mesh4_moe``, a spawn of its own). Returns the placed runs'
    launches."""
    from repro_torch.launch.mesh import make_codist_mesh, spawn_pods
    have = torch.cuda.device_count()
    require(have >= 4, f"mesh4 needs 4 cards, one a rank; this host has "
            f"{have}")
    t0 = time.perf_counter()
    ranks = spawn_pods(mesh4_rank, 4, (), device=str(dev), timeout_s=1500.0,
                       mesh=make_codist_mesh(*MESH4_PARITY[0]))
    log(f"mesh4: 4 ranks on 4 cards ({torch.cuda.get_device_name(0)}), "
        f"{time.perf_counter() - t0:.1f} s with the spawn")
    return mesh4_checks(ranks, smi_line)


def mesh4_checks(ranks: list, smi_line: str) -> dict:
    """``phase_mesh4``'s checks of its ranks' results; returns the placed
    runs' launches."""
    from repro_torch.configs import get_config
    cfg = replace(get_config(MESH_ARCH), num_layers=MESH_LAYERS,
                  dtype="float32")
    launches = dict.fromkeys(ALL_LOSS_KERNELS, 0)
    for j, job in enumerate(ranks[0]["parity"]):
        if job["shape"] is None:
            continue
        runs = [r["parity"][j] for r in ranks]
        plain = next(r for r in ranks[0]["parity"]
                     if r["shape"] is None and r["wire"] == job["wire"])
        label, topk = job["label"], job["wire"] == "topk"
        want = expected_launches(1, "mse", MESH_STEPS, combined=not topk,
                                 task_ce=topk, standalone=0)
        entry = "_CEParts" if topk else "_CEDistillTokens"
        for r, run in enumerate(runs):
            got = {k: run["launches"][k] for k in ALL_LOSS_KERNELS}
            require(got == want, f"{label} rank {r}: launches {got} != {want}")
            require(run["entry"][entry] == MESH_STEPS
                    and sum(run["entry"].values()) == MESH_STEPS,
                    f"{label} rank {r}: DTensor entry calls {run['entry']}")
            for k, v in got.items():
                launches[k] += v
        worst = 0.0
        for r, run in enumerate(runs):
            for a, b in zip(plain["records"], run["records"]):
                for m in ("loss", "task_loss", "distill_loss"):
                    rel = abs(b[m] - a[m]) / max(abs(a[m]), 1e-12)
                    worst = max(worst, rel)
                    require(rel <= MESH4_TOL, f"{label} rank {r} step "
                            f"{a['step']} {m}: {b[m]} vs the single card's "
                            f"{a[m]}")
            require(run["leaf_err"][0] <= MESH4_TOL, f"{label} rank {r}: a "
                    f"leaf differs by {run['leaf_err'][0]:.3e} absolute")
        first, last = plain["records"][0]["loss"], plain["records"][-1]["loss"]
        moved = abs(last - first) / abs(first)
        require(moved > 100 * MESH4_TOL, f"{label}: the loss moved by only "
                f"{moved:.2e} relative over {MESH_STEPS} steps")
        comm = runs[0]["records"][-1]["comm_bytes"]
        for pod in (0, 1):
            got_b = sum(run["wire_bytes"] for run in runs if run["pod"] == pod)
            require(got_b == comm, f"{label} pod {pod}: the gather metered "
                    f"{got_b} bytes, comm_bytes {comm}")
        wall = [float(np.mean(run["step_s"][1:])) * 1e3 for run in runs]
        wire = [float(np.mean(run["wire_s"][1:])) * 1e3 for run in runs]
        log(f"{label}: losses {[round(x['loss'], 6) for x in runs[0]['records']]}"
            f" within {worst:.2e} relative of the single card (tol "
            f"{MESH4_TOL:g}), leaves within "
            f"{max(run['leaf_err'][0] for run in runs):.2e} absolute, the "
            f"loss moved {moved:.2e} relative; gather bytes a pod == "
            f"comm_bytes ({comm:.0f}); wall a step (steps 1-2) "
            + ", ".join(f"{w:.1f}" for w in wall) + " ms, the gather "
            + ", ".join(f"{x:.2f}" for x in wire) + " ms; peak "
            + ", ".join(f"{run['peak_bytes'] / 2**30:.2f}" for run in runs)
            + " GiB")
    big_cfg = replace(get_config(BIG_ARCH), num_layers=BIG_LAYERS)
    runs = [r["big"] for r in ranks]
    recs = runs[0]["records"]
    require(all(len(run["records"]) == MESH_STEPS for run in runs),
            "mesh4 deepseek: short Histories")
    require(recs[-1]["loss"] != recs[0]["loss"],
            f"mesh4 deepseek: the loss did not move ({recs[0]['loss']})")
    want = expected_launches(1, "mse", MESH_STEPS, combined=True,
                             task_ce=False, standalone=0)
    for r, run in enumerate(runs):
        got = {k: run["launches"][k] for k in ALL_LOSS_KERNELS}
        require(got == want, f"mesh4 deepseek rank {r}: launches {got}")
        for k, v in got.items():
            launches[k] += v
    want_b = MESH_STEPS * cross_pod_cost(big_cfg, "codist", BIG_MESH,
                                         2 * BIG_B, BIG_S)
    comm = recs[-1]["comm_bytes"]
    for r, run in enumerate(runs):
        require(run["wire_bytes"] == want_b, f"mesh4 deepseek rank {r}: the "
                f"gather metered {run['wire_bytes']} bytes, the cost model "
                f"{want_b} (the bf16 wire)")
    n_par, state_b = big_peer_bytes(big_cfg)
    wall = float(np.mean(runs[0]["step_s"][1:])) * 1e3
    wire = float(np.mean(runs[0]["wire_s"][1:])) * 1e3
    dev_ms = runs[0]["device_ms"]
    log(f"mesh4 deepseek: {BIG_ARCH} {BIG_LAYERS} of 95 layers, full width, "
        f"bf16 over fp32 masters, AdamW, 2 peers of {BIG_B} x {BIG_S} on "
        f"{BIG_MESH}: losses {[round(x['loss'], 5) for x in recs]}; rank 0 "
        f"wall a step (steps 1-2, under torch.profiler) {wall:.1f} ms, device "
        + (f"{dev_ms / (MESH_STEPS - 1):.1f} ms a step (steps 1-2)"
           if dev_ms else "not measured")
        + f"; the pod gather (NCCL) {wire:.2f} ms a step ({wire / wall:.1%}),"
        f" {runs[0]['wire_bytes'] // MESH_STEPS} bytes a step on rank 0 "
        f"(the bf16 wire, == launch/cost.py's; comm_bytes {comm:.0f} a pod "
        f"in {MESH_STEPS} steps at fp32); a peer {n_par / 1e9:.3f} B "
        f"parameters, {state_b / 1e9:.1f} GB of master, gradient and AdamW "
        f"moments at 16 B a parameter, {2 * state_b / 1e9:.1f} GB for both "
        "(one 80 GB card cannot hold them); peak a rank "
        + ", ".join(f"{run['peak_bytes'] / 1e9:.1f}" for run in runs)
        + f" GB; {smi_line}")
    mesh4_baseline(ranks, cfg, big_cfg, launches, smi_line)
    mesh4_paper(ranks, launches, smi_line)
    return launches


def cross_pod_cost(cfg, mode: str, shape, rows: int, seq: int,
                   k: int = 1) -> int:
    """``launch/cost.py``'s cross-pod bytes a device of one step of
    ``mode`` on the (pod, data, model) mesh ``shape`` over ``rows``
    sequences of ``seq`` positions (a VLM's patches among them) in k
    microbatches."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.cost import step_cost
    from repro_torch.launch.mesh import make_codist_mesh
    return step_cost(cfg, InputShape("mesh4", seq, rows, "train"), mode,
                     microbatch=k, mesh=make_codist_mesh(*shape)
                     ).collectives.cross_pod_bytes


def mesh4_baseline(ranks, cfg, big_cfg, launches: dict, smi_line: str
                   ) -> None:
    """mesh4's checks of the all-reduce baseline, the microbatched runs and
    the other families (``mesh4_rank``'s ``held`` runs and deepseek's
    ``AllReduce``): each rank's losses within MESH4_NEW_TOL relative of
    its single-card step and its shards of every leaf within MESH4_TOL;
    launches exact (rows 6 and 7, or 12 and 13, once a rank a microbatch),
    each through the DTensor entry; the cross-pod bytes each rank metered
    (the optimizer's reduction over "pod", or the pod gather of the fp32
    none wire) equal to ``launch/cost.py``'s a step. The parity runs of
    the none wire are held to the cost model the same way."""
    for job in ranks[0]["parity"]:
        if job["shape"] is None or job["wire"] != "none":
            continue
        want = MESH_STEPS * cross_pod_cost(cfg, "codist", job["shape"],
                                           2 * MESH_B, MESH_S)
        got = [j["wire_bytes"] for r in ranks for j in r["parity"]
               if j["label"] == job["label"]]
        require(got == [want] * len(ranks), f"{job['label']}: the ranks "
                f"metered {got} bytes, the cost model {want}")
        log(f"{job['label']}: each rank's pod gather {want // MESH_STEPS} "
            "bytes a step == launch/cost.py's cross-pod bytes")
    for j, job in enumerate(ranks[0]["held"]):
        runs = [r["held"][j] for r in ranks]
        label = job["label"]
        one = "allreduce" in job["name"]
        arch_cfg = job["cfg"]
        k = 2 if job["name"].endswith("k2") else 1
        per = k * MESH_STEPS
        want = expected_launches(1, "mse", per, combined=not one,
                                 task_ce=one, standalone=0)
        entry = "_CEParts" if one else "_CEDistillTokens"
        bytes_a_step = cross_pod_cost(arch_cfg, "allreduce" if one
                                      else "codist", job["shape"],
                                      job["rows"], job["seq"], k)
        worst = 0.0
        for r, run in enumerate(runs):
            got = {n: run["launches"][n] for n in ALL_LOSS_KERNELS}
            require(got == want, f"{label} rank {r}: launches {got} != "
                    f"{want}")
            require(run["entry"][entry] == per
                    and sum(run["entry"].values()) == per,
                    f"{label} rank {r}: DTensor entry calls {run['entry']}")
            for n, v in got.items():
                launches[n] += v
            for a, b in zip(run["plain"], run["records"]):
                for m in ("loss", "task_loss", "distill_loss"):
                    if m not in a:
                        continue
                    rel = abs(b[m] - a[m]) / max(abs(a[m]), 1e-12)
                    worst = max(worst, rel)
                    require(rel <= MESH4_NEW_TOL, f"{label} rank {r} step "
                            f"{a['step']} {m}: {b[m]} vs the single card's "
                            f"{a[m]}")
            require(run["leaf_err"][0] <= MESH4_TOL, f"{label} rank {r}: a "
                    f"leaf differs by {run['leaf_err'][0]:.3e} absolute")
            metered = run["pod_bytes"] if one else run["wire_bytes"]
            require(metered == MESH_STEPS * bytes_a_step, f"{label} rank {r}:"
                    f" metered {metered} cross-pod bytes, the cost model "
                    f"{MESH_STEPS * bytes_a_step}")
        first, last = runs[0]["plain"][0]["loss"], runs[0]["plain"][-1]["loss"]
        wall = [float(np.mean(run["step_s"][1:])) * 1e3 for run in runs]
        losses = [round(x["loss"], 6) for x in runs[0]["records"]]
        log(f"{label}: losses {losses} within {worst:.2e} relative of the "
            f"single card (tol {MESH4_NEW_TOL:g}), leaves within "
            f"{max(run['leaf_err'][0] for run in runs):.2e} absolute, the "
            f"loss moved {abs(last - first) / abs(first):.2e} relative; "
            f"cross-pod bytes a rank a step {bytes_a_step} "
            f"({'gradient reduction over pod' if one else 'pod gather'}) == "
            f"launch/cost.py's; wall a step (steps 1-2) "
            + ", ".join(f"{w:.1f}" for w in wall) + " ms; peak "
            + ", ".join(f"{run['peak_bytes'] / 2**30:.2f}" for run in runs)
            + " GiB")
    runs = [r["big_ar"] for r in ranks]
    recs = runs[0]["records"]
    require(all(len(run["records"]) == MESH_STEPS for run in runs),
            "mesh4 deepseek allreduce: short Histories")
    require(recs[-1]["loss"] != recs[0]["loss"], "mesh4 deepseek allreduce: "
            f"the loss did not move ({recs[0]['loss']})")
    want = expected_launches(1, "mse", MESH_STEPS, combined=False,
                             task_ce=True, standalone=0)
    sync_b = cross_pod_cost(big_cfg, "allreduce", BIG_MESH, 2 * BIG_B, BIG_S)
    for r, run in enumerate(runs):
        got = {k: run["launches"][k] for k in ALL_LOSS_KERNELS}
        require(got == want, f"mesh4 deepseek allreduce rank {r}: launches "
                f"{got}")
        require(run["entry"]["_CEParts"] == MESH_STEPS,
                f"mesh4 deepseek allreduce rank {r}: entry {run['entry']}")
        for k, v in got.items():
            launches[k] += v
        require(run["pod_bytes"] == MESH_STEPS * sync_b, f"mesh4 deepseek "
                f"allreduce rank {r}: the gradient reduction over pod metered "
                f"{run['pod_bytes']} bytes, the cost model "
                f"{MESH_STEPS * sync_b}")
    cd = ranks[0]["big"]
    wall = float(np.mean(runs[0]["step_s"][1:])) * 1e3
    pod = float(np.mean(runs[0]["pod_s"][1:])) * 1e3
    dev_ms = runs[0]["device_ms"]
    cd_wall = float(np.mean(cd["step_s"][1:])) * 1e3
    cd_wire = float(np.mean(cd["wire_s"][1:])) * 1e3
    cd_dev = cd["device_ms"]
    log(f"mesh4 deepseek allreduce: {BIG_ARCH} {BIG_LAYERS} of 95 layers, "
        f"full width, bf16 over fp32 masters, AdamW, one model of "
        f"{2 * BIG_B} x {BIG_S} on {BIG_MESH} (rows over pod, TP 2): losses "
        f"{[round(x['loss'], 5) for x in recs]}; rank 0 wall a step (steps "
        f"1-2, under torch.profiler, a device sync around each leaf's "
        f"reduction over pod) {wall:.1f} ms, device "
        + (f"{dev_ms / (MESH_STEPS - 1):.1f} ms a step" if dev_ms
           else "not measured")
        + f"; the cross-pod gradient all-reduce (NCCL) {pod:.2f} ms a step "
        f"({pod / wall:.1%}), {runs[0]['pod_bytes'] // MESH_STEPS} bytes a "
        f"rank a step (== launch/cost.py's), "
        f"{runs[0]['pod_reductions'] // MESH_STEPS} leaves; peak a rank "
        + ", ".join(f"{run['peak_bytes'] / 1e9:.1f}" for run in runs)
        + f" GB. Beside it, codist on the same mesh in this run: rank 0 wall "
        f"{cd_wall:.1f} ms, device "
        + (f"{cd_dev / (MESH_STEPS - 1):.1f} ms" if cd_dev else "not measured")
        + f" a step, the pod gather {cd_wire:.2f} ms, "
        f"{cd['wire_bytes'] // MESH_STEPS} bytes a rank a step; {smi_line}")


def mean_ms(xs) -> float:
    """The mean of steps 1.. of a run's per-step seconds, in ms."""
    return float(np.mean(xs[1:] or xs)) * 1e3


def mesh4_paper(ranks, launches: dict, smi_line: str) -> None:
    """mesh4's paper models side by side (their parity, launches and bytes
    are checked with the other ``held`` runs): for each, on one mesh, the
    codist step and the baseline's, rank 0's wall and device ms a step
    (steps 1-2, under torch.profiler; the baseline with a device sync
    around each leaf's reduction over "pod"), the cross-pod ms and bytes a
    rank a step, their ratio (resnet50's beside the paper's b_model /
    b_pred), each rank's peak, the single card's step beside them. Then
    transformer-big in bf16 over fp32 masters with AdamW, both strategies
    on PAPER_BF16's mesh: finite, moving losses, launches exact, the
    baseline's bytes and the bf16 wire's equal to ``launch/cost.py``'s
    (which prices the wire at the logits' own bits)."""
    from repro_torch.core import comm_model as cm
    held = [r["held"] for r in ranks]

    def runs(name, shape):
        i = next((j for j, job in enumerate(held[0])
                  if job["name"] == name and job["shape"] == shape), None)
        return None if i is None else [h[i] for h in held]

    def desc(rs, one):
        r0 = rs[0]
        steps = len(r0["records"])
        meter = "pod_s" if one else "wire_s"
        b = (r0["pod_bytes"] if one else r0["wire_bytes"]) // steps
        dev = r0["device_ms"]
        plain = r0["plain_run"]
        return b, (
            f"wall {mean_ms(r0['step_s']):.1f} ms, device "
            + (f"{dev / (steps - 1):.1f} ms" if dev else "not measured")
            + f" a step; cross-pod {mean_ms(r0[meter]):.2f} ms for {b} bytes "
            f"a rank a step ({'the gradient reduction over pod' if one else 'the pod gather'}); "
            "peak " + ", ".join(f"{x['peak_bytes'] / 2**30:.2f}" for x in rs)
            + " GiB; single card wall "
            + f"{mean_ms(plain['step_s']):.1f} ms, device "
            + (f"{plain['device_ms'] / (steps - 1):.1f} ms"
               if plain["device_ms"] else "not measured"))

    for arch, b, s, _lr, frozen, cd_meshes, ar_meshes in PAPER_MESH4:
        for shape in cd_meshes:
            cd = runs(f"{arch} codist", shape)
            ar = runs(f"{arch} allreduce", shape)
            cd_b, cd_txt = desc(cd, False)
            line = (f"mesh4 paper {arch} on {shape}, fp32, "
                    f"{'2 peers x ' + str(b) + (' x ' + str(s) if s else ' images')}"
                    f"{', stem + s0 frozen' if frozen else ''}: codist {cd_txt}")
            if ar is not None:
                ar_b, ar_txt = desc(ar, True)
                line += (f"; allreduce (one model of {2 * b} rows) {ar_txt};"
                         f" bytes allreduce / codist {ar_b / cd_b:.1f}")
                if arch == "resnet50":
                    b_model, b_pred = 8e8, 3.2e4    # Section 3's numbers
                    rows = b // shape[1]
                    line += (f" (the paper's b_model / b_pred {b_model / b_pred:.0f}"
                             f" a sample, {b_model / (b_pred * rows):.1f} over "
                             f"the {rows} rows a device holds; its C_AR / "
                             "C_pred at 256 samples, T 1: "
                             f"{cm.paper_resnet50_numbers()['pred_T1_ratio']:.1f})")
            log(line + f"; {smi_line}")
    bf = [r["paper_bf16"] for r in ranks]
    arch, b, s, shape = PAPER_BF16
    parts = []
    for mode in ("codist", "allreduce"):
        rs = [x[mode] for x in bf]
        one = mode == "allreduce"
        recs = rs[0]["records"]
        require(all(len(x["records"]) == MESH_STEPS for x in rs),
                f"mesh4 {arch} bf16 {mode}: short Histories")
        require(recs[-1]["loss"] != recs[0]["loss"], f"mesh4 {arch} bf16 "
                f"{mode}: the loss did not move ({recs[0]['loss']})")
        want = expected_launches(1, "mse", MESH_STEPS, combined=not one,
                                 task_ce=one, standalone=0)
        cost = cross_pod_cost(rs[0]["cfg"], mode, shape, rs[0]["rows"], s)
        for r, x in enumerate(rs):
            got = {k: x["launches"][k] for k in ALL_LOSS_KERNELS}
            require(got == want, f"mesh4 {arch} bf16 {mode} rank {r}: "
                    f"launches {got}")
            for k, v in got.items():
                launches[k] += v
            metered = x["pod_bytes"] if one else x["wire_bytes"]
            require(metered == MESH_STEPS * cost, f"mesh4 {arch} bf16 {mode} "
                    f"rank {r}: metered {metered} cross-pod bytes (the cost "
                    f"model {MESH_STEPS * cost})")
        r0 = rs[0]
        meter = "pod_s" if one else "wire_s"
        by = (r0["pod_bytes"] if one else r0["wire_bytes"]) // MESH_STEPS
        dev = r0["device_ms"]
        parts.append((by, f"{mode} losses {[round(x['loss'], 5) for x in recs]}"
                      f", wall {mean_ms(r0['step_s']):.1f} ms, device "
                      + (f"{dev / (MESH_STEPS - 1):.1f} ms"
                         if dev else "not measured")
                      + f" a step, cross-pod {mean_ms(r0[meter]):.2f} ms for "
                      f"{by} bytes a rank a step, peak "
                      + ", ".join(f"{x['peak_bytes'] / 2**30:.2f}" for x in rs)
                      + " GiB"))
    log(f"mesh4 paper {arch} bf16 over fp32 masters, AdamW lr 1e-4, 2 peers "
        f"x {b} x {s} (the baseline one model of {2 * b} x {s}) on {shape}: "
        + "; ".join(p for _b, p in parts)
        + f"; bytes allreduce / codist {parts[1][0] / parts[0][0]:.1f}; "
        + smi_line)


# ----------------------------------------------------------------------------
# on request: rows 1, 1q, 2 and 4 against the parent commit
# ----------------------------------------------------------------------------

def phase_rows(dev: torch.device, dump: str) -> None:
    """Rows 1, 1q, 2 and 4 at qwen2-7b's main shapes (``kernel_inputs``):
    the decode over bf16 and fp32 pools (q of the pool's type) and over
    int8 / fp8 pools (bf16 q), the K+V scatter of bf16 rows into bf16 pools
    and the quantizing K+V scatter into int8 / fp8 pools; each output and
    each launch's time (``time_ms``) saved to ``dump``. Uses only the
    wrappers' public API, so the same phase runs on an older tree's package
    (``--src``)."""
    from repro_torch.kernels import (paged_attention_decode, paged_scatter_kv,
                                     paged_scatter_quant_kv)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    t = {k: torch.from_numpy(v).to(dev) for k, v in kernel_inputs().items()}
    lengths, table, ws, wo = t["lengths"], t["table"], t["wslot"], t["woff"]
    out, ms = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, new = (t[x].to(dt) for x in ("q", "k", "v", "new"))
        name = str(dt)[6:]
        out[f"row1 {name}"] = paged_attention_decode(q, k, v, table, lengths)
        ms[f"row1 {name}"] = time_ms(
            lambda: paged_attention_decode(q, k, v, table, lengths), flush)
        kk, vv = k.clone(), v.clone()
        paged_scatter_kv(kk, vv, new, new, ws, wo)
        out[f"row2 {name} k"], out[f"row2 {name} v"] = kk, vv
        ms[f"row2 {name}"] = time_ms(
            lambda: paged_scatter_kv(kk, vv, new, new, ws, wo), flush)
    q, new = t["q"].to(torch.bfloat16), t["new"].to(torch.bfloat16)
    for qdt in QUANT:
        name = str(qdt)[6:]
        kq, ks, vq, vs = quantized_pools(t["k"], t["v"], qdt)
        out[f"row1q {name}"] = paged_attention_decode(q, kq, vq, table,
                                                      lengths, ks, vs)
        ms[f"row1q {name}"] = time_ms(lambda: paged_attention_decode(
            q, kq, vq, table, lengths, ks, vs), flush)
        pools = [x.clone() for x in (kq, ks, vq, vs)]
        paged_scatter_quant_kv(*pools, new, new, ws, wo)
        for key, x in zip(("k", "k_scale", "v", "v_scale"), pools):
            out[f"row4 {name} {key}"] = x
        ms[f"row4 {name}"] = time_ms(
            lambda: paged_scatter_quant_kv(*pools, new, new, ws, wo), flush)
    sync(dev)
    torch.save({"out": {k: x.cpu() for k, x in out.items()}, "ms": ms}, dump)
    log("rows: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))


def phase_parent(child: str = "rows") -> None:
    """``child`` (``rows`` or ``bwd_rows``) in four processes, in turns: the
    parent's tree (``PARENT``, a ``git archive`` of the parent commit whose
    kernels build into its own ``build/``), this tree, this tree, the
    parent. Every output (or its digest) must be bit for bit the same in
    all four; prints each launch's time in the four runs and this tree's
    mean over the parent's."""
    runs = [("parent", PARENT), ("this", ROOT), ("this", ROOT),
            ("parent", PARENT)]
    got = []
    for i, (who, root) in enumerate(runs):
        dump = os.path.join(ROOT, "build", f"{child}_{i}.pt")
        os.makedirs(os.path.dirname(dump), exist_ok=True)
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--phases",
             f"device,{child}", "--src", os.path.join(root, "src"), "--dump",
             dump], capture_output=True, text=True, timeout=900)
        require(proc.returncode == 0, f"parent: the {who} run {i} failed:\n"
                f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        got.append(torch.load(dump))
    for key, want in got[0]["out"].items():
        same = bits_equal if isinstance(want, torch.Tensor) else (
            lambda a, b: a == b)
        require(all(same(g["out"][key], want) for g in got[1:]),
                f"parent: {key} differs between the parent and this tree")
    log(f"parent: {len(got[0]['out'])} outputs of {child} bit for bit equal "
        "in the four runs (parent, this, this, parent)")
    for key in got[0]["ms"]:
        t = [g["ms"][key] for g in got]
        base, mine = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        log(f"  {key}: parent {t[0]:.4f}, {t[3]:.4f}  this {t[1]:.4f}, "
            f"{t[2]:.4f} ms  (this / parent {mine / base:.4f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + ON_REQUEST))
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the package tree to import (rows: an older tree's)")
    ap.add_argument("--dump", default="",
                    help="rows, bwd_rows: write the outputs and times here")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    bad = sorted(set(phases) - set(PHASES + ON_REQUEST))
    if bad:
        ap.error(f"unknown phases {bad}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi_line = phase_device()
    if any(p in phases for p in ("rows", "parent", "bwd_rows", "bwd_parent")):
        if "rows" in phases:
            phase_rows(dev, args.dump)
        if "bwd_rows" in phases:
            phase_bwd_rows(dev, args.dump)
        if "parent" in phases:
            phase_parent("rows")
        if "bwd_parent" in phases:
            phase_parent("bwd_rows")
        log(smi_line)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    # the split forward's mutant builds beside the kernels
    mutant = start_mutant_build() if "kernels" in phases else None
    try:
        return run_phases(phases, dev, t_start, smi_line, mutant)
    finally:
        if mutant is not None and mutant[0].poll() is None:
            mutant[0].kill()
            mutant[0].wait()


def run_phases(phases, dev, t_start, smi_line, mutant) -> int:
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
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
        for name, recs in phase_distill_splits(dev, flush, mutant).items():
            kernel_rows[name]["by_shape"] = recs
        for name, recs in phase_bwd_narrow(dev, flush).items():
            kernel_rows.setdefault(name, {})["bwd_narrow"] = recs
        del flush
        log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    launches = {}          # path -> {kernel: launches on that path's run}
    if "fleet" in phases:
        t0 = time.perf_counter()
        launches["fleet"] = phase_fleet(dev, get_config("qwen2-7b"),
                                        smi_line)
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
        launches["train"] = phase_train(dev, smi_line)
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
    if "single" in phases:
        t0 = time.perf_counter()
        phase_single(dev)
        torch.cuda.empty_cache()
        log(f"phase single: {time.perf_counter() - t0:.1f} s")
    if "obs" in phases:
        t0 = time.perf_counter()
        launches["obs"] = phase_obs(dev, smi_line)
        torch.cuda.empty_cache()
        log(f"phase obs: {time.perf_counter() - t0:.1f} s")
    if "paper" in phases:
        t0 = time.perf_counter()
        launches["paper"], paper_rows = phase_paper(dev)
        for name, recs in paper_rows.items():
            kernel_rows.setdefault(name, {})["paper_shapes"] = recs
        torch.cuda.empty_cache()
        log(f"phase paper: {time.perf_counter() - t0:.1f} s")
    if "families" in phases:
        t0 = time.perf_counter()
        launches["families"] = phase_families(dev, smi_line)
        torch.cuda.empty_cache()
        log(f"phase families: {time.perf_counter() - t0:.1f} s")
    if "rwkv" in phases:
        t0 = time.perf_counter()
        launches["rwkv"], rwkv_rows = phase_rwkv(dev, smi_line)
        for name, recs in rwkv_rows.items():
            kernel_rows.setdefault(name, {})["rwkv_shapes"] = recs
        torch.cuda.empty_cache()
        log(f"phase rwkv: {time.perf_counter() - t0:.1f} s")
    if "shardmap" in phases:
        t0 = time.perf_counter()
        launches["shardmap"] = phase_shardmap(dev)
        torch.cuda.empty_cache()
        log(f"phase shardmap: {time.perf_counter() - t0:.1f} s")
    if "mesh" in phases:
        t0 = time.perf_counter()
        launches["mesh"] = phase_mesh(dev)
        log(f"phase mesh: {time.perf_counter() - t0:.1f} s")
    if "mesh4" in phases:
        t0 = time.perf_counter()
        launches["mesh4"] = phase_mesh4(dev, smi_line)
        log(f"phase mesh4: {time.perf_counter() - t0:.1f} s")
    if "mesh4moe" in phases or "mesh4" in phases:
        t0 = time.perf_counter()
        launches["mesh4moe"] = phase_mesh4_moe(dev, smi_line)
        log(f"phase mesh4moe: {time.perf_counter() - t0:.1f} s")
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
               if k.startswith(("verify_", "canary_", "by_shape",
                                "paper_", "rwkv_", "heads", "bwd_"))}})
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
