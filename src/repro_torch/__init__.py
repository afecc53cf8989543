"""PyTorch/CUDA port of the codistillation system.

A second package beside the JAX reference (``repro``), which it never
imports. Slice 1 carries the serving path — ``launch/serve.py`` fleet
mode, ``FleetRouter`` -> ``FleetEngine`` -> ``PagedCachePool`` ->
``build_decode_step`` — with the three paged-KV kernels of that path.
Slice 2 carries training — ``launch/train.py`` in modes ``codist`` and
``allreduce`` -> ``train/loop.py`` -> ``train/engine.py`` ->
``core/codistillation.py`` ``codist_loss`` — with the four fused loss
kernels of that path (CE and CE + distillation, forward and backward).
Slice 3 adds n peers, the top-k and subsample wires, the checkpoint and
pipelined exchanges (``codist-ckpt``, ``codist-pipelined``) and the
checkpoint format (``checkpoint/io.py``), with the four distillation
kernels those reach (the distillation term alone, forward and backward).
Slice 4 adds quantized (int8 / fp8) KV pools to the fleet
(``--cache-dtype int8|fp8``), with the quantizing scatter and the
dequantizing decode, and the two standalone kernels of ``kernels/ops.py``
(``cross_entropy_tokens``, ``attention``), so every Pallas kernel of the
reference has a counterpart. Slice 8 adds the paper-grid harness
(``experiments/``: spec -> runner -> aggregate, ``launch/sweep.py``) and
the async peer runtime (``runtime/``: fault clock, mailbox, peers,
``AsyncScheduler``; ``--mode codist-async``). Slice 13 adds the paper's
own models (``models/conv.py`` resnet50 / wrn28x10 with GroupNorm,
``models/encdec.py`` transformer-big, ``models/mlp.py`` and
``data/multiview.py`` for the Section-5.1 study), trained through
``build_model`` and ``train/loop.py``. Slice 14 adds the MoE and hybrid
families (``models/moe.py``, ``models/mamba.py``: grok-1, arctic, jamba)
to training, ``Engine.generate`` and the paged fleet, whose pool keeps
dense per-slot recurrent states beside the paged KV. Slice 15 adds the
attention-free rwkv6 (``models/rwkv.py``). Slice 16 adds the VLM patch
prefix (internvl2) and whisper-tiny to ``Engine.generate`` and ``--single``,
and the pod exchange: ``--mode codist-shardmap`` runs one process per
model in a ``torch.distributed`` group (``launch/mesh.py``) whose only
collective is the gather of the compressed prediction wire
(``ShardMapCompressed``). The kernels are written by hand in CUDA C++ for
Hopper (``csrc/``); the models are the dense, MoE, hybrid, attention-free
and VLM LMs, the enc-dec transformer, the conv nets and the MLP.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
asking for CUDA without a card raises (nothing falls back to the CPU). On a
CPU tensor a kernel wrapper runs its plain PyTorch version, which is what
the CPU tests hold against the JAX reference.
"""
import torch


def resolve_device(device="cuda", meta: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    there is no card. ``meta=True`` also admits ``"meta"``: shape stand-ins
    that allocate nothing (``LM.init`` / ``init_cache`` for
    ``launch/specs.py``); nothing computes there."""
    dev = torch.device(device)
    if meta and dev.type == "meta":
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
