"""The port's configs repair, roofline, cost model and dry-run CLI
(``repro_torch.configs``, ``repro_torch.launch.roofline`` / ``cost`` /
``dryrun``) held against the JAX reference and the port's own step.

* configs: ``param_count`` of all 13 registered archs (the conv nets have
  none in either package), ``attention_free``, ``INPUT_SHAPES``,
  ``ASSIGNED_ARCHS`` and ``comm_model.codist_cost(mode="checkpoints")``
  equal the reference's;
* roofline: ``active_params`` and ``model_flops`` for every assigned arch x
  shape equal the reference's, but for grok-1's geglu experts, which
  count 3 matrices as ``param_count`` does (the reference takes off 2);
  ``build_report``'s terms are the FLOPs and
  bytes over the H100's peaks;
* the dry-run helpers: ``pick_microbatch``, ``adapt_for_shape``, ``SKIP``
  and the 39-combination coverage equal the reference's;
* the cost model against the port's own program on the CPU: the GEMM
  FLOPs of a reduced config of each family (dense, MoE, arctic, jamba
  hybrid, rwkv6, enc-dec over frames and over source tokens, VLM, the conv
  nets, the multi-view MLP) equal ``FlopCounterMode``'s count over the
  port's codist train step (forward + backward, with and without remat),
  its prefill and its decode step, within 1%; the MoE configs route to
  E = top_k experts, where the training capacity (factor 1.25) drops no
  token;
* the kernels' bytes: rows 5-13 at T 4096, V 152064, bf16 give ``PERF.md``
  §6's bound column, rows 1-4 at the main shapes ``chip_smoke.py``'s own
  bounds;
* collectives: the codist wire's cross-pod bytes equal ``comm_model``'s
  over the columns a device holds (none: V / tp, as the logits are placed;
  top-k: whole), the all-reduce baseline's equal its gradient sync;
* the CLI: ``--all`` on each mesh writes 39 ok records with the
  reference's keys and a useful share of at most 1, a second run resumes
  and says so, ``--fresh`` counts again, and the peak RSS stays under 4 GB.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported, so
it is imported inside the tests that need it, with ``monkeypatch``
restoring the variable.
"""
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import CodistConfig as JCodistConfig
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.core import comm_model as jcm
from repro.launch import roofline as jrl
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, CodistConfig,
                                 InputShape, TrainConfig, get_config,
                                 get_reduced, list_archs)
from repro_torch.core import comm_model as cm
from repro_torch.launch import cost as pc
from repro_torch.launch import roofline as prl
from repro_torch.launch import sharding as psh
from repro_torch.launch import specs as psp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.mlp import MLP, MLPConfig
from repro_torch.optim import make_optimizer
from repro_torch.train import (AllReduce, PredictionExchange,
                               build_train_step, stack_batches)
from repro_torch.train.state import init_codist_state, init_train_state

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file, the caller's count restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jdr(monkeypatch):
    """The reference's dryrun module, its XLA_FLAGS write undone after."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.launch.dryrun as dr
    return dr


def _dry(arch):
    return replace(get_config(arch), dtype="bfloat16", param_dtype="bfloat16")


# ----------------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jax_list_archs())
def test_param_count_equals_the_reference(arch):
    assert sorted(list_archs()) == sorted(jax_list_archs())
    j, p = jax_get_config(arch), get_config(arch)
    assert hasattr(p, "param_count") == hasattr(j, "param_count")
    if hasattr(j, "param_count"):
        assert p.param_count() == j.param_count()
        assert p.attention_free == j.attention_free


def test_shapes_archs_and_the_checkpoint_cost_equal_the_reference():
    assert ASSIGNED_ARCHS == J_ASSIGNED
    assert {k: tuple(v.__dict__.values()) for k, v in INPUT_SHAPES.items()} \
        == {k: tuple(v.__dict__.values()) for k, v in J_SHAPES.items()}
    qwen = cm.codist_cost(get_config("qwen2-7b"),
                          CodistConfig(mode="checkpoints"), 8, 512)
    assert qwen.bits_per_iter_per_device == 243699613696.0
    for arch in ASSIGNED_ARCHS:
        for n, period in ((2, 1), (3, 5)):
            got = cm.codist_cost(get_config(arch), CodistConfig(
                n_models=n, period=period, mode="checkpoints"), 8, 512)
            want = jcm.codist_cost(jax_get_config(arch), JCodistConfig(
                n_models=n, period=period, mode="checkpoints"), 8, 512)
            assert got == cm.CommCost(want.bits_per_iter_per_device,
                                      want.scheme), arch


# ----------------------------------------------------------------------------
# roofline and the dry-run helpers
# ----------------------------------------------------------------------------

def test_roofline_helpers_equal_the_reference():
    for arch in ASSIGNED_ARCHS:
        p, j = _dry(arch), replace(jax_get_config(arch), dtype="bfloat16",
                                   param_dtype="bfloat16")
        if p.moe is not None and p.act == "geglu":
            # the reference gives a geglu expert 2 matrices where its own
            # param_count gives it 3; the port takes off all 3 of each
            # inactive expert
            m = p.moe
            n_moe = sum(p.is_moe_layer(i) for i in range(p.num_layers))
            inactive = n_moe * (m.num_experts - m.top_k) * p.d_model * p.d_ff
            assert prl.active_params(p) == p.param_count() - 3 * inactive
            assert jrl.active_params(j) - prl.active_params(p) == inactive
            for name in INPUT_SHAPES:
                assert prl.model_flops(p, INPUT_SHAPES[name]) == \
                    pytest.approx(jrl.model_flops(j, J_SHAPES[name])
                                  * prl.active_params(p)
                                  / jrl.active_params(j), rel=1e-12)
            continue
        assert prl.active_params(p) == jrl.active_params(j), arch
        for name in INPUT_SHAPES:
            assert prl.model_flops(p, INPUT_SHAPES[name]) == \
                jrl.model_flops(j, J_SHAPES[name]), (arch, name)
    r = prl.build_report("qwen2-7b", INPUT_SHAPES["train_4k"], "16x16", 256,
                         2e15, 3e11, 9e9, 1e9, 4e8, _dry("qwen2-7b"))
    assert r.compute_s == 2e15 / 989e12 and r.memory_s == 3e11 / 3.35e12
    assert r.collective_s == 9e9 / 450e9 + 1e9 / 50e9
    assert r.bottleneck == "compute" and r.collective_bytes == 1e10
    assert r.useful_ratio == prl.model_flops(
        _dry("qwen2-7b"), INPUT_SHAPES["train_4k"]) / (2e15 * 256)
    assert "| qwen2-7b | train_4k |" in prl.format_table([r])
    assert prl.node_of(7) == 0 and prl.node_of(8) == 1


def test_dryrun_helpers_equal_the_reference(jdr):
    from repro_torch.launch import dryrun as pdr
    assert pdr.SKIP == jdr.SKIP
    assert pdr.SLIDING_WINDOW_FOR_LONG == jdr.SLIDING_WINDOW_FOR_LONG
    combos = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES
              if (a, s) not in pdr.SKIP]
    assert len(combos) == 39
    for arch in ASSIGNED_ARCHS:
        pc_, jc_ = pdr.dryrun_config(arch), jdr.dryrun_config(arch)
        assert (pc_.dtype, pc_.param_dtype) == (jc_.dtype, jc_.param_dtype)
        for name in INPUT_SHAPES:
            pa, ja = (pdr.adapt_for_shape(pc_, name),
                      jdr.adapt_for_shape(jc_, name))
            assert pa.sliding_window == ja.sliding_window, (arch, name)
            for ways in (16, 32):
                for n in (1, 2):
                    assert pdr.pick_microbatch(pa, INPUT_SHAPES[name], ways,
                                               n) == \
                        jdr.pick_microbatch(ja, J_SHAPES[name], ways, n)


# ----------------------------------------------------------------------------
# the cost model against FlopCounterMode over the port's own step
# ----------------------------------------------------------------------------

def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _lm_batch(cfg, b, s, g):
    text = s - cfg.num_patches
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, text),
                                     generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (b, text),
                                     generator=g),
             "mask": torch.ones(b, text)}
    if cfg.num_patches:
        batch["patches"] = torch.randn(b, cfg.num_patches, cfg.d_model,
                                       generator=g)
    if cfg.is_encdec and cfg.num_audio_frames:
        batch["frames"] = torch.randn(b, cfg.num_audio_frames, cfg.d_model,
                                      generator=g)
    elif cfg.is_encdec:
        batch["src_tokens"] = torch.randint(0, cfg.vocab_size, (b, s),
                                            generator=g)
    return batch


def _no_drop(arch):
    """The reduced config routing to E = top_k experts: every expert takes
    every token, within the training capacity ceil(1.25 T k / E)."""
    cfg = get_reduced(arch)
    return replace(cfg, moe=replace(cfg.moe, num_experts=cfg.moe.top_k))


FAMILIES = {
    "dense": lambda: get_reduced("qwen2-7b"),
    "moe": lambda: _no_drop("grok-1-314b"),
    "arctic": lambda: _no_drop("arctic-480b"),
    "hybrid": lambda: _no_drop("jamba-v0.1-52b"),
    "rwkv": lambda: get_reduced("rwkv6-1.6b"),
    "encdec_frames": lambda: get_reduced("whisper-tiny"),
    "encdec_tokens": lambda: replace(get_reduced("transformer-big"),
                                     num_audio_frames=0),
    "vlm": lambda: get_reduced("internvl2-76b"),
}
# (seq, remat): rwkv at two chunks of 64; the window config stays short
SEQ = {"rwkv": 128}


def _within(got, want, what):
    assert got > 0 and abs(want - got) <= 0.01 * got, (what, got, want)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_lm_gemm_flops_equal_flop_counter(family, remat):
    cfg = FAMILIES[family]()
    b, s = 2, SEQ.get(family, 48)
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    cd = CodistConfig(n_models=2)
    state = init_codist_state(model, g, 2, make_optimizer("sgdm")[0],
                              device="cpu")
    batch = stack_batches([_lm_batch(cfg, b, s, g) for _ in range(2)])
    bundle = build_train_step(model, TrainConfig(
        optimizer="sgdm", remat=remat, total_steps=4, warmup_steps=0), cd,
        PredictionExchange(cd))
    _within(_flops(lambda: bundle.apply(state, batch, 1)),
            pc.step_cost(cfg, InputShape("t", s, 2 * b, "train"), "codist",
                         2, remat=remat).gemm_flops, f"{family} train")
    if remat:
        return
    params = model.init(g, device="cpu")
    pre = _lm_batch(cfg, b, s, g)
    del pre["labels"], pre["mask"]
    cap = s + 8
    with torch.no_grad():
        _within(_flops(lambda: model.prefill(params, pre, cap)),
                pc.step_cost(cfg, InputShape("p", s, b, "prefill"),
                             "prefill").gemm_flops, f"{family} prefill")
        _, cache = model.prefill(params, pre, cap)
        tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=g)
        _within(_flops(lambda: model.decode(params, cache, tok, s)),
                pc.step_cost(cfg, InputShape("d", cap, b, "decode"),
                             "decode").gemm_flops, f"{family} decode")


@pytest.mark.parametrize("arch", ["resnet50", "wrn28x10", "mlp", "allreduce"])
def test_small_model_gemm_flops_equal_flop_counter(arch):
    g = torch.Generator().manual_seed(0)
    b = 4
    if arch == "mlp":
        cfg = MLPConfig(in_dim=32, hidden=(64, 48), num_classes=10)
        model = MLP(cfg)

        def mk():
            return {"features": torch.randn(b, cfg.in_dim, generator=g),
                    "labels": torch.randint(0, 10, (b,), generator=g,
                                            dtype=torch.int32)}
    elif arch == "allreduce":
        cfg = get_reduced("qwen1.5-0.5b")
        model = build_model(cfg)
        tc = TrainConfig(optimizer="sgdm", total_steps=4, warmup_steps=0)
        state = init_train_state(model, g, make_optimizer("sgdm")[0],
                                 device="cpu")
        bundle = build_train_step(model, tc, None, AllReduce())
        batch = _lm_batch(cfg, b, 32, g)
        _within(_flops(lambda: bundle.apply(state, batch, 1)),
                pc.step_cost(cfg, InputShape("t", 32, b, "train"),
                             "allreduce", remat=False).gemm_flops,
                "allreduce")
        return
    else:
        cfg = get_reduced(arch)
        model = build_model(cfg)

        def mk():
            return {"images": torch.randn(b, cfg.image_size, cfg.image_size,
                                          3, generator=g),
                    "labels": torch.randint(0, cfg.num_classes, (b,),
                                            generator=g, dtype=torch.int32)}
    cd = CodistConfig(n_models=2)
    state = init_codist_state(model, g, 2, make_optimizer("sgdm")[0],
                              device="cpu")
    bundle = build_train_step(model, TrainConfig(
        optimizer="sgdm", total_steps=4, warmup_steps=0), cd,
        PredictionExchange(cd))
    batch = stack_batches([mk() for _ in range(2)])
    _within(_flops(lambda: bundle.apply(state, batch, 1)),
            pc.step_cost(cfg, InputShape("t", 1, 2 * b, "train"),
                         "codist", 2).gemm_flops, arch)


# ----------------------------------------------------------------------------
# the kernels' bytes (PERF.md §6)
# ----------------------------------------------------------------------------

def _ms(nbytes):
    return round(nbytes / 3.35e12 * 1e3, 4)


def test_loss_rows_give_the_bound_column():
    t, v = 4096, 152064
    want = {"fused_cross_entropy": 0.3719, "fused_cross_entropy_parts": 0.3719,
            "fused_cross_entropy_grad": 0.7437, "fused_distill_loss": 0.7437,
            "fused_distill_kl_parts": 0.7437,
            "fused_distill_mse_grad": 1.1156, "fused_distill_kl_grad": 1.1156,
            "fused_ce_distill_parts": 0.7437, "fused_ce_distill_grad": 1.1156}
    for name, ms in want.items():
        assert _ms(pc.loss_kernel_io(name, t, v, 2)[0]) == ms, name
    for name in ("fused_distill_mse_grad", "fused_distill_kl_grad",
                 "fused_ce_distill_grad"):          # with dB / dt
        assert _ms(pc.loss_kernel_io(name, t, v, 2, True)[0]) == 1.4874
    # the kl forms of rows 8, 12 and 13: the same logits bytes, two more
    # fp32 vectors for rows 12 and 13, more operations a logit
    for name, big, small, ops in (("fused_distill_loss", 2, 1, 11),
                                  ("fused_ce_distill_parts", 2, 7, 11),
                                  ("fused_ce_distill_grad", 3, 7, 12)):
        assert pc.loss_kernel_io(name, t, v, 2, mode="kl") == (
            big * t * v * 2 + small * t * 4, ops * t * v), name
    # a launch's bound: the larger of bytes / HBM and operations / peak
    assert pc.kernel_bound_ms(3.35e9, 134e9) == (2.0, "operations")
    assert pc.kernel_bound_ms(3.35e9, 0) == (1.0, "bytes")


def test_paged_rows_give_chip_smokes_bounds():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    # one table of peaks, and chip_smoke's loss rows bounded by this module
    assert cs.HBM_BPS == prl.HBM_BW
    assert cs.PEAK_FLOPS[torch.float32] == prl.PEAK_FLOPS_FP32
    assert cs.PEAK_FLOPS[torch.bfloat16] == prl.PEAK_FLOPS
    ms, by = cs.loss_bound("fused_ce_distill_grad", 4096, 152064, 2,
                           target_grad=True)
    assert round(ms, 4) == 1.4874 and by == "bytes"
    inp = cs.kernel_inputs()
    lengths = [int(x) for x in inp["lengths"]]
    # row 1: its bytes bound in time_decode
    rows = sum(x + 1 for x in lengths)
    row_b = cs.KVH * cs.HD * 2
    want = (2 * rows * row_b + 2 * cs.S * cs.H * cs.HD * 2 + cs.S * cs.MB * 4
            + cs.S * 4)
    got, ops = pc.paged_decode_io(lengths, cs.H, cs.KVH, cs.HD, 2, 2, cs.MB)
    assert abs(got - want) <= 0.01 * want and ops == 4 * cs.H * cs.HD * rows
    assert round(got / cs.HBM_BPS * 1e3, 4) == 0.0022
    q = pc.paged_decode_io(lengths, cs.H, cs.KVH, cs.HD, 1, 2, cs.MB, True)[0]
    assert round(q / cs.HBM_BPS * 1e3, 4) == 0.0012
    # the verify's pseudo-slots share K/V rows: the bytes read them once
    shared = pc.paged_decode_io(lengths, cs.H, cs.KVH, cs.HD, 2, 2, cs.MB,
                                byte_rows=100)
    assert shared == (got - 2 * (rows - 100) * row_b, ops)
    # row 3: the gather's bound in phase_kernels
    live = sum((x + cs.BS) // cs.BS for x in lengths)
    block_b = cs.BS * cs.KVH * cs.HD * 2
    want = (live * block_b + cs.S * cs.MB * block_b + cs.S * cs.MB * 4
            + cs.S * 4)
    got = pc.paged_gather_io(live, cs.S, cs.MB, block_b)
    assert abs(got - want) <= 0.01 * want
    assert round(got / cs.HBM_BPS * 1e3, 4) == 0.0038
    # rows 2 and 4: the K+V launch with the scatter phase's 15 writers
    s2 = pc.paged_scatter_io(15, row_b, cs.NB)
    assert abs(s2 - (4 * 15 * row_b + 2 * cs.NB * 4)) <= 0.01 * s2
    assert round(s2 / cs.HBM_BPS * 1e3, 7) == 0.0000208
    s4 = pc.paged_scatter_io(15, row_b, cs.NB, cs.KVH * cs.HD + 4)
    assert round(s4 / cs.HBM_BPS * 1e3, 7) == 0.0000162


def test_fleet_tick_counts_the_paged_rows_once_a_layer():
    cfg = get_config("qwen2-7b")
    lengths = [5, 30, 100]
    paged = {"lengths": lengths, "num_blocks": 1025, "max_blocks": 34}
    c = pc.step_cost(cfg, InputShape("tick", 544, 3, "decode"), "decode",
                     variant={"paged": paged})
    assert c.parts["paged_attention_decode"][2] == cfg.num_layers
    assert c.parts["paged_scatter"][2] == cfg.num_layers
    dense = pc.step_cost(cfg, InputShape("tick", 544, 3, "decode"), "decode")
    assert "layers/sub0/mix.scores" in dense.parts
    assert "layers/sub0/mix.scores" not in c.parts
    assert c.gemm_flops < dense.gemm_flops


# ----------------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("comp", ["none", "topk"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "internvl2-76b",
                                  "jamba-v0.1-52b"])
def test_codist_cross_pod_bytes_are_the_comm_models_wire(arch, comp):
    cfg, shape = _dry(arch), INPUT_SHAPES["train_4k"]
    mesh = make_production_mesh(multi_pod=True)
    extra = {"compression": comp, "topk": 64}
    c = pc.step_cost(cfg, shape, "codist", 2, microbatch=4, mesh=mesh,
                     codist_extra=extra)
    per_device = shape.global_batch // 2 // mesh.shape["data"]
    # the production configs train in bf16: the wire carries bf16 logits
    want = cm.codist_cost(cfg, CodistConfig(n_models=2, compression=comp,
                                            topk=64), per_device,
                          shape.seq_len - cfg.num_patches, logit_bits=16)
    # a device holds V / tp columns of the none wire (the logits' "btv"
    # placement) and the whole top-k wire
    cols = 1 if comp == "topk" else mesh.shape["model"]
    assert c.collectives.cross_pod_bytes == int(
        want.bits_per_iter_per_device / 8 / cols)
    assert [o.kind for o in c.collectives.ops if o.cross_pod] == \
        ["all-gather"]
    # on one pod the codist wire never leaves the device's own pod
    single = pc.step_cost(cfg, shape, "codist", 2, microbatch=4,
                          mesh=make_production_mesh(), codist_extra=extra)
    assert single.collectives.cross_pod_bytes == 0


@pytest.mark.parametrize("comp", ["none", "topk"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-67b"])
def test_bf16_codist_wire_is_priced_at_the_logits_bits(arch, comp):
    """A bf16 model sends bf16 logits: on the multi-pod production mesh the
    codist wire's cross-pod bytes are ``comm_model``'s at 16 bits (the
    top-k values at 16, their indices at 32), and the same model in fp32
    sends twice the none wire's bytes and (32 + 32) / (16 + 32) times the
    top-k wire's."""
    cfg, shape = _dry(arch), INPUT_SHAPES["train_4k"]
    mesh = make_production_mesh(multi_pod=True)
    extra = {"compression": comp, "topk": 64}

    def wire(c):
        return pc.step_cost(c, shape, "codist", 2, mesh=mesh,
                            codist_extra=extra).collectives.cross_pod_bytes
    per_device = shape.global_batch // 2 // mesh.shape["data"]
    cols = 1 if comp == "topk" else mesh.shape["model"]
    bits = {}
    for width in (16, 32):
        bits[width] = cm.codist_cost(
            cfg, CodistConfig(n_models=2, compression=comp, topk=64),
            per_device, shape.seq_len - cfg.num_patches,
            logit_bits=width).bits_per_iter_per_device / 8 / cols
    assert wire(cfg) == int(bits[16]) > 0
    fp32 = wire(replace(cfg, dtype="float32"))
    assert fp32 == int(bits[32])
    assert fp32 * (16 + 32 if comp == "topk" else 1) == wire(cfg) * (
        64 if comp == "topk" else 2)


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ["grok-1-314b", "jamba-v0.1-52b"])
def test_expert_all_to_all_is_the_capacity_buffers(arch, kind):
    """With ``moe_expert_axis="data"`` (the E dim over "data", which 8 and
    16 experts divide on (2, 8, 16)) every MoE layer exchanges each
    device's (G, E, C, d) capacity buffers each way: a routing group a
    batch row (a token a slot in decode), C the GShard capacity of a train
    step or the group's tokens in decode; 2 exchanges a forward, 2 a
    backward and 2 in the remat forward, each microbatch's groups at a
    time; no exchange without the expert axis."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.moe import _capacity
    cfg = _dry(arch)
    mesh = Mesh((2, 8, 16), ("pod", "data", "model"))
    shape = INPUT_SHAPES["train_4k" if kind == "train" else "decode_32k"]
    m = cfg.moe
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    for mode, k in (("allreduce", 1), ("codist", 2)):
        kw = dict(microbatch=k, mesh=mesh) if kind == "train" else dict(
            mesh=mesh)
        c = pc.step_cost(cfg, shape, mode if kind == "train" else "decode",
                         variant={"moe_expert_axis": "data"}, **kw)
        ops = [o for o in c.collectives.ops if o.kind == "all-to-all"]
        if kind == "train":
            # rows over (pod, data) for one model, over data a peer
            groups = shape.global_batch // 16 // k
            per_op = groups * m.num_experts * _capacity(
                m, shape.seq_len, 1.25) * cfg.d_model * 2
            reps = 2 * 3 * n_moe * k
        else:     # one model's slots over (pod, data)
            groups = shape.global_batch // 16
            per_op = groups * m.num_experts * 1 * cfg.d_model * 2
            reps = 2 * n_moe
        assert len(ops) == reps, (mode, len(ops))
        assert {o.operand_bytes for o in ops} == {per_op}, mode
        assert all(len(g) == 8 and not o.cross_pod
                   for o in ops for g in o.groups)
        plain = pc.step_cost(cfg, shape, mode if kind == "train" else
                             "decode", **kw)
        assert not any(o.kind == "all-to-all" for o in plain.collectives.ops)


@pytest.mark.parametrize("arch", ["qwen2-7b", "grok-1-314b"])
def test_allreduce_cross_pod_bytes_are_the_gradient_sync(arch):
    cfg, shape = _dry(arch), INPUT_SHAPES["train_4k"]
    mesh = make_production_mesh(multi_pod=True)
    c = pc.step_cost(cfg, shape, "allreduce", mesh=mesh, microbatch=2)
    params = psp.params_specs(build_model(cfg))
    specs = psh.state_shardings(params, mesh)
    flat = dict(psh.tree_flatten_with_path(specs))
    want = sum(torch.Size(psh.local_shape(tuple(x.shape), flat[p],
                                          mesh)).numel() * x.element_size()
               for p, x in psh.tree_flatten_with_path(params))
    assert c.collectives.cross_pod_bytes == pytest.approx(want, abs=len(flat))
    assert {o.kind for o in c.collectives.ops if o.cross_pod} == \
        {"all-reduce"}
    # the groups come from the mesh's device ids: pods of 256
    assert all(len({d // 256 for d in g}) == 2
               for o in c.collectives.ops if o.cross_pod for g in o.groups)


# ----------------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------------

KEYS = {"arch", "shape", "mesh", "mode", "variant", "codist_extra", "chips",
        "memory", "cost", "collectives", "roofline", "status"}


def test_cli_covers_39_combinations_on_each_mesh(tmp_path):
    code = (
        "import resource\n"
        "from repro_torch.launch.dryrun import main\n"
        f"out = {str(tmp_path)!r}\n"
        "main(['--all', '--mesh', 'single', '--out', out])\n"
        "main(['--all', '--mesh', 'multi', '--out', out])\n"
        "main(['--all', '--mesh', 'single', '--out', out])\n"
        "main(['--all', '--mesh', 'single', '--out', out, '--fresh'])\n"
        "print('RSS_KB', resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert sum(ln.startswith("[dryrun] cached") for ln in lines) == 39
    summary = [ln for ln in lines if " ok (" in ln]
    assert [ln.split(" -> ")[0] for ln in summary] == [
        "[dryrun] 39/39 ok (39 counted by this run, 0 read from the file)"] * 2 \
        + ["[dryrun] 39/39 ok (0 counted by this run, 39 read from the file)",
           "[dryrun] 39/39 ok (39 counted by this run, 0 read from the file)"]
    rss_kb = int([ln for ln in lines if ln.startswith("RSS_KB")][0].split()[1])
    assert rss_kb < 4 * 1024 * 1024
    for mesh, chips in (("single", 256), ("multi", 512)):
        recs = json.loads((tmp_path / f"dryrun_{mesh}_auto.json").read_text())
        assert len(recs) == 39
        for rec in recs:
            assert rec["status"] == "ok" and KEYS <= set(rec), rec.get("error")
            assert rec["chips"] == chips
            assert rec["memory"]["argument_bytes"] > 0
            assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                                     "collective")
            # the useful work never exceeds the counted work
            assert 0 < rec["roofline"]["useful_ratio"] <= 1, rec["arch"]
        modes = {r_["mode"] for r_ in recs if r_["shape"] == "train_4k"}
        assert modes == ({"codist"} if mesh == "multi" else {"allreduce"})
        cross = [r_["collectives"]["cross_pod_bytes"] for r_ in recs]
        assert (max(cross) > 0) == (mesh == "multi")
