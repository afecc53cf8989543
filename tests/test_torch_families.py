"""The MoE and hybrid families (grok-1, arctic, jamba) on the port, held
against the JAX reference on the CPU at reduced size, on the reference's
weights carried across by the bridge and inputs made with numpy.

* ``moe_forward`` (gated geglu as grok, plain relu -> gelu, arctic's dense
  residual) at capacity factor 1.25 with drops (a group of 16 tokens, a
  skewed router) and at 0: outputs within 1e-5 of max|ref|, aux within
  1e-6; ``router_decisions`` dispatch equal and combine within 1e-6, with
  drops and with tied logits (ties go to the lowest expert index). In
  bf16, on experts that compute exactly, the output equals the
  reference's: the combine weights are rounded to bf16 as there.
* The Mamba block: ``mamba_forward``, the state ``mamba_prefill`` leaves
  and ``mamba_decode`` steps after it, at L = 8, 128 and 256 (two
  chunks), within 1e-5 relative; a length past one chunk that is not a
  multiple of it raises on both sides. A bf16 decode over an fp32 state
  keeps the state's conv values exactly, as the reference's promotion does.
* The reference's ``test_models_extra.py`` MoE and ``TestMambaState``
  properties, held on the port.
* ``LM.forward`` logits and aux of the three reduced configs within 1e-4
  of max|ref|; the trees equal the reference's leaf for leaf.
* Decode against teacher forcing (a fresh prefill for MoE archs, as
  ``test_serve_consistency.py`` does) and against the reference's decode;
  ``Engine.generate`` tokens equal the reference's, uniform and ragged;
  jamba's decode from bf16 caches promotes the conv state as the
  reference's does.
* The fleet's streams equal the reference's ``Engine.generate`` for jamba
  and grok (``test_fleet.py``'s hybrid-and-moe case) over fp32 and int8
  pools, on both attention paths, with a re-admitted slot; grok's
  speculative streams equal plain ones; jamba's speculative policy raises.
* Three ``train_codist`` steps per family: History losses, aux and
  ``comm_bytes`` within 1e-5 relative; three all-reduce steps of grok-1
  (the total is task + aux); plain SGD from a state without a buffer, and
  an update in flat slices, bit-equal to the momentum-0 update.
* A checkpoint round trip of a jamba tree, both directions; the serving
  cast keeps the fp32-read leaves.
* internvl2, whisper-tiny and rwkv6 (ported since): full and reduced
  configs equal the reference's field by field, and build its model
  class.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.configs import CodistConfig as JCodistConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import build_model as jax_build_model
from repro.models import mamba as jmb
from repro.models import moe as jmoe
from repro.optim import make_optimizer as jax_make_optimizer
from repro.serve import Engine as JaxEngine
from repro.train import AllReduce as JAllReduce
from repro.train import build_train_step as jax_build_train_step
from repro.train import train_codist as jax_train_codist
from repro.train.state import init_codist_state as jax_init_codist_state
from repro.train.state import init_train_state as jax_init_train_state
from repro_torch.checkpoint import (load_pytree, opt_state_from_jax,
                                    params_from_jax, params_to_numpy,
                                    peer_params_from_jax, save_pytree,
                                    serving_params)
from repro_torch.configs import (CodistConfig, TrainConfig, get_config,
                                 get_reduced)
from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig
from repro_torch.models import build_model
from repro_torch.models import mamba as mb
from repro_torch.models import moe
from repro_torch.serve import Engine
from repro_torch.serve.fleet import (FleetConfig, FleetRouter, Request,
                                     SpecConfig)
from repro_torch.train import AllReduce, build_train_step, train_codist
from repro_torch.train.state import CodistState, TrainState, trainable_params

ARCHS = ["grok-1-314b", "arctic-480b", "jamba-v0.1-52b"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file, the caller's count restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (err, tol)


def _close_rel(got, want, tol=1e-5):
    g, w = float(got), float(want)
    assert abs(g - w) <= tol * max(1.0, abs(w)), (g, w)


def _cfg(mod, **kw):
    """The reference ``test_models_extra.py``'s small config, on either
    side (``mod`` is a tuple of the side's config classes)."""
    model_cfg, moe_cfg, ssm_cfg = mod
    base = dict(name="t", family="dense", num_layers=2, d_model=64,
                num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=64,
                head_dim=32, dtype="float32")
    if kw.pop("moe", False):
        base["moe"] = moe_cfg(num_experts=kw.pop("experts", 4), top_k=2,
                              dense_residual=kw.pop("residual", False))
    if kw.pop("ssm", False):
        base["ssm"] = ssm_cfg()
    base.update(kw)
    return model_cfg(**base)


JAX_CFGS = (JModelConfig, JMoEConfig, JSSMConfig)
PORT_CFGS = (ModelConfig, MoEConfig, SSMConfig)


# ----------------------------------------------------------------------------
# the MoE block
# ----------------------------------------------------------------------------

MOE_VARIANTS = {"gated-geglu": dict(act="geglu"),
                "plain-relu": dict(act="relu"),
                "dense-residual": dict(act="silu", residual=True)}


def _moe_pair(variant, skew=1.0):
    kw = dict(family="moe", moe=True, **MOE_VARIANTS[variant])
    jc, pc = _cfg(JAX_CFGS, **dict(kw)), _cfg(PORT_CFGS, **dict(kw))
    jp = jmoe.init_moe(jax.random.key(0), jc)
    jp = dict(jp, router=jp["router"] * skew)
    return jc, pc, jp, params_from_jax(_np(jp), device="cpu")


@pytest.mark.parametrize("cf", [1.25, 0.0], ids=["cf1.25-drops", "cf0"])
@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
def test_moe_forward_matches_reference(variant, cf):
    """A skewed router over groups of 16 tokens: at 1.25 some pairs drop
    (checked), at 0 none."""
    jc, pc, jp, pp = _moe_pair(variant, skew=6.0)
    x = np.random.default_rng(1).standard_normal((3, 16, 64)).astype(
        np.float32)
    jy, jaux = jax.jit(lambda p, v: jmoe.moe_forward(
        p, v, jc, capacity_factor=cf))(jp, jnp.asarray(x))
    y, aux = moe.moe_forward(pp, _t(x), pc, capacity_factor=cf)
    _close(y.numpy(), jy, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    logits = _t(x).float() @ pp["router"]
    cap = moe._capacity(pc.moe, 16, cf)
    _idx, _v, _pos, keep, _aux = moe._route(pc.moe, logits, cap)
    assert bool(keep.all()) == (cf == 0.0), "drops at 1.25, none at 0"


def _exact_bf16_experts(jp, e, d, f):
    """Expert stacks whose products are exact in bf16 on both sides: w_gate
    and w_up pick input j into hidden j (w_up / 16 beside a gate), w_down
    takes it back scaled by a power of 2 per expert. With inputs in {16,
    24, 32, 48} every activation is the identity (gelu and silu round to
    x there) and every product and expert output is a bf16 number, so the
    output differs only where the combine weights do."""
    eye = np.zeros((d, f), np.float32)
    eye[np.arange(d), np.arange(d)] = 1.0
    out = dict(jp)
    if "w_gate" in jp:
        out["w_gate"] = jnp.asarray(np.stack([eye] * e), jnp.bfloat16)
        out["w_up"] = jnp.asarray(np.stack([eye / 16] * e), jnp.bfloat16)
    else:
        out["w_up"] = jnp.asarray(np.stack([eye] * e), jnp.bfloat16)
    out["w_down"] = jnp.asarray(np.stack(
        [eye.T * 2.0 ** (1 - i) for i in range(e)]), jnp.bfloat16)
    return out


@pytest.mark.parametrize("cf", [1.25, 0.0], ids=["cf1.25-drops", "cf0"])
@pytest.mark.parametrize("variant", ["gated-geglu", "plain-relu"])
def test_moe_forward_bf16_rounds_the_gates_as_the_reference(variant, cf):
    """bf16 activations and weights: the reference casts the combine
    weights to bf16 before the product (``moe.py:116-117``). On experts
    that compute exactly in bf16 the port's output equals the reference's;
    at most 1% of the elements may differ (by one bf16 ulp) where an fp32
    router sum in another order moves a gate across a rounding boundary.
    fp32 gates leave 15-28% of them different."""
    kw = dict(family="moe", moe=True, dtype="bfloat16", **MOE_VARIANTS[variant])
    jc, pc = _cfg(JAX_CFGS, **dict(kw)), _cfg(PORT_CFGS, **dict(kw))
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      jmoe.init_moe(jax.random.key(0), jc))
    jp = _exact_bf16_experts(jp, 4, 64, 128)
    jp["router"] = jp["router"] * 0.1
    pp = params_from_jax(_np(jp), device="cpu")
    x = np.random.default_rng(1).choice([16.0, 24.0, 32.0, 48.0],
                                        size=(3, 16, 64)).astype(np.float32)
    jy, jaux = jax.jit(lambda p, v: jmoe.moe_forward(
        p, v, jc, capacity_factor=cf))(jp, jnp.asarray(x, jnp.bfloat16))
    y, aux = moe.moe_forward(pp, _t(x).to(torch.bfloat16), pc,
                             capacity_factor=cf)
    assert y.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    got = y.float().numpy()
    off = got != want
    assert off.mean() <= 0.01, f"{off.mean():.1%} of the elements differ"
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert bool((np.abs(got - want) <= ulp).all())
    assert abs(float(aux) - float(jaux)) <= 1e-6
    logits = _t(x) @ pp["router"].float()
    keep = moe._route(pc.moe, logits, moe._capacity(pc.moe, 16, cf))[3]
    assert bool(keep.all()) == (cf == 0.0), "drops at 1.25, none at 0"


@pytest.mark.parametrize("case", ["drops", "ties-nodrop"])
def test_router_decisions_match_reference(case):
    m, jm_ = MoEConfig(num_experts=4, top_k=2), JMoEConfig(num_experts=4,
                                                            top_k=2)
    rng = np.random.default_rng(2)
    if case == "drops":
        logits = (rng.standard_normal((16, 4)) * 3).astype(np.float32)
        cap = 5
    else:   # integer logits: equal probabilities, ties on every row
        logits = rng.integers(0, 2, (16, 4)).astype(np.float32)
        cap = 16
    jd, jcmb, jaux = jmoe.router_decisions(jm_, jnp.asarray(logits), cap)
    d, cmb, aux = moe.router_decisions(m, _t(logits), cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(cmb.numpy(), np.asarray(jcmb), rtol=0,
                               atol=1e-6)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert (float(d.sum()) < 32) == (case == "drops")


# the reference's test_models_extra.py TestMoE, on the port

def test_router_combine_weights_sum_to_one_without_drops():
    m = MoEConfig(num_experts=4, top_k=2)
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 4)).astype(np.float32))
    _d, combine, _a = moe.router_decisions(m, logits, capacity=16)
    np.testing.assert_allclose(combine.sum(dim=(1, 2)).numpy(), 1.0,
                               rtol=1e-5)


def test_capacity_drops_reduce_combine_mass():
    m = MoEConfig(num_experts=2, top_k=2)
    logits = torch.tensor([[5.0, 4.0]]).repeat(16, 1)
    _, full, _ = moe.router_decisions(m, logits, capacity=16)
    _, tiny, _ = moe.router_decisions(m, logits, capacity=2)
    assert float(tiny.sum()) < float(full.sum())


def test_nodrop_capacity():
    m = MoEConfig(num_experts=4, top_k=2)
    assert moe._capacity(m, tokens=100, capacity_factor=0.0) == 100
    assert moe._capacity(m, tokens=100, capacity_factor=1.25) < 100
    jm_ = JMoEConfig(num_experts=4, top_k=2)
    for t in (1, 3, 4, 7, 16, 100, 513):
        for cf in (0.0, 1.0, 1.25, 2.0):
            assert moe._capacity(m, t, cf) == jmoe._capacity(jm_, t, cf)


def test_load_balance_loss_minimized_by_uniform_router():
    m = MoEConfig(num_experts=4, top_k=1)
    uniform = torch.zeros((64, 4))
    skewed = torch.tensor([[10.0, 0, 0, 0]]).repeat(64, 1)
    _, _, aux_u = moe.router_decisions(m, uniform, 32)
    _, _, aux_s = moe.router_decisions(m, skewed, 32)
    assert float(aux_u) < float(aux_s)


def test_moe_forward_nodrop_equals_manual_mixture():
    """With no drops the output is sum_k gate_k * expert_k(x)."""
    cfg = _cfg(PORT_CFGS, family="moe", act="silu", moe=True, experts=2)
    jp = jmoe.init_moe(jax.random.key(0), _cfg(JAX_CFGS, family="moe",
                                                act="silu", moe=True,
                                                experts=2))
    p = params_from_jax(_np(jp), device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 4, 64)).astype(np.float32))
    y, _ = moe.moe_forward(p, x, cfg, capacity_factor=0.0)
    gates = torch.softmax(x @ p["router"], dim=-1)

    def expert(e):
        h = torch.nn.functional.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])
        return h @ p["w_down"][e]
    want = sum(gates[..., e:e + 1] * expert(e) for e in range(2))
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------------
# the Mamba block
# ----------------------------------------------------------------------------

def _mamba_pair():
    jc = _cfg(JAX_CFGS, family="hybrid", ssm=True, attn_layer_period=2)
    pc = _cfg(PORT_CFGS, family="hybrid", ssm=True, attn_layer_period=2)
    jp = jmb.init_mamba(jax.random.key(0), jc)
    return jc, pc, jp, params_from_jax(_np(jp), device="cpu")


@pytest.mark.parametrize("length", [8, 128, 256])
def test_mamba_forward_prefill_decode_match_reference(length):
    jc, pc, jp, pp = _mamba_pair()
    x = (np.random.default_rng(3).standard_normal((2, length + 3, 64))
         * 0.5).astype(np.float32)
    jx, px = jnp.asarray(x), _t(x)
    j_fwd = jax.jit(lambda p, v: jmb.mamba_forward(p, v, jc))
    j_pre = jax.jit(lambda p, v: jmb.mamba_prefill(p, v, jc))
    j_dec = jax.jit(lambda p, v, s: jmb.mamba_decode(p, v, s, jc))
    _close(mb.mamba_forward(pp, px[:, :length], pc).numpy(),
           j_fwd(jp, jx[:, :length]), 1e-5)
    jy, js = j_pre(jp, jx[:, :length])
    y, st = mb.mamba_prefill(pp, px[:, :length], pc)
    _close(y.numpy(), jy, 1e-5)
    for k in ("h", "conv"):
        _close(st[k].numpy(), js[k], 1e-5)
        assert st[k].dtype == torch.float32
    for i in range(length, length + 3):
        jy, js = j_dec(jp, jx[:, i:i + 1], js)
        y, st = mb.mamba_decode(pp, px[:, i:i + 1], st, pc)
        _close(y.numpy(), jy, 1e-5)
        for k in ("h", "conv"):
            _close(st[k].numpy(), js[k], 1e-5)


def test_mamba_decode_bf16_over_fp32_state_matches_reference():
    """bf16 activations and weights over an fp32 state (a quantized pool's
    states): the reference's ``concatenate`` promotes the conv window to
    fp32, so the new ``conv`` keeps the state's fp32 values and the new
    input exactly; ``h`` within 1e-5 relative and the output within two
    bf16 ulps of max|ref|. A window cast to bf16 leaves conv ~4e-3 and h
    ~1e-4 relative from the reference's."""
    kw = dict(family="hybrid", ssm=True, attn_layer_period=2,
              dtype="bfloat16")
    jc, pc = _cfg(JAX_CFGS, **dict(kw)), _cfg(PORT_CFGS, **dict(kw))
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      jmb.init_mamba(jax.random.key(0), jc))
    pp = params_from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(4)
    st = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
          for k, v in jmb.init_mamba_state(jc, 2, jnp.float32).items()}
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 1, 64)) * 0.5,
                               jnp.bfloat16).astype(jnp.float32))
    jy, js = jax.jit(lambda p, v, s: jmb.mamba_decode(p, v, s, jc))(
        jp, jnp.asarray(x, jnp.bfloat16), {k: jnp.asarray(v)
                                           for k, v in st.items()})
    y, s2 = mb.mamba_decode(pp, _t(x).to(torch.bfloat16),
                            {k: _t(v) for k, v in st.items()}, pc)
    assert s2["conv"].dtype == s2["h"].dtype == torch.float32
    np.testing.assert_array_equal(s2["conv"].numpy(), np.asarray(js["conv"]))
    _close(s2["h"].numpy(), js["h"], 1e-5)
    want = np.asarray(jy.astype(jnp.float32))
    assert y.dtype == torch.bfloat16
    _close(y.float().numpy(), want, 2.0 ** -7)


def test_mamba_chunk_assert_as_the_reference():
    """A sequence past one chunk must be a multiple of it (the reference's
    ``mamba_scan`` asserts): 200 tokens raise on both sides."""
    jc, pc, jp, pp = _mamba_pair()
    x = np.zeros((1, 200, 64), np.float32)
    with pytest.raises(AssertionError):
        jmb.mamba_forward(jp, jnp.asarray(x), jc)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mb.mamba_forward(pp, _t(x), pc)


def test_mamba_prefill_state_matches_stepwise():
    """The reference's ``TestMambaState`` on the port: the prefill's state
    equals eight decode steps' from a zero state."""
    _jc, pc, _jp, pp = _mamba_pair()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 8, 64)).astype(np.float32)) * 0.5
    _, pre = mb.mamba_prefill(pp, x, pc)
    state = mb.init_mamba_state(pc, 1, torch.float32)
    for i in range(8):
        _, state = mb.mamba_decode(pp, x[:, i:i + 1], state, pc)
    for k in ("h", "conv"):
        np.testing.assert_allclose(pre[k].numpy(), state[k].numpy(),
                                   rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------------
# the three LMs
# ----------------------------------------------------------------------------

_MODELS = {}


def _models(arch):
    """(jax model, its params, port model, bridged params) of a reduced
    arch, made once per module (the reference's init runs jitted: the same
    draws, one compile instead of one per op)."""
    if arch not in _MODELS:
        jm = jax_build_model(jax_get_reduced(arch))
        jp = jax.jit(jm.init)(jax.random.key(1))
        pm = build_model(get_reduced(arch))
        _MODELS[arch] = (jm, jp, pm, params_from_jax(_np(jp), device="cpu"))
    return _MODELS[arch]


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """One arch on both sides with one set of bridged weights."""
    return (request.param, *_models(request.param))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def test_lm_forward_and_tree_match_reference(fam):
    arch, jm, jp, pm, pp = fam
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = {p: (tuple(t.shape), str(t.dtype)[6:])
            for p, t in _flat(pm.init(gen, device="cpu"))}
    ref = {tuple(k.key for k in p): (tuple(a.shape), str(a.dtype))
           for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert mine == ref, arch
    toks = np.random.default_rng(7).integers(0, pm.cfg.padded_vocab, (2, 16),
                                             dtype=np.int32)
    jl, ja = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        pl, pa = pm.forward(pp, {"tokens": _t(toks).long()})
    _close(pl.numpy(), jl, 1e-4)
    _close(pa.numpy(), ja, 1e-4)
    assert float(pa) > 0


def test_decode_matches_teacher_forcing_and_reference(fam):
    """Prefill 8 of 12 tokens, then 4 decode steps: each step's logits
    within 2e-4 of the reference's decode and within 5e-4 of the port's
    truth (the teacher-forced forward; for MoE archs a fresh prefill,
    since training drops and serving does not)."""
    arch, jm, jp, pm, pp = fam
    toks = np.random.default_rng(7).integers(0, pm.cfg.padded_vocab, (2, 12),
                                             dtype=np.int32)
    tt = _t(toks).long()
    split, cap = 8, 14

    def truth(i):
        if pm.cfg.moe is None:
            return pm.forward(pp, {"tokens": tt})[0][:, i]
        return pm.prefill(pp, tt[:, :i + 1], cap, torch.float32)[0][:, 0]

    with torch.no_grad():
        lg, cache = pm.prefill(pp, tt[:, :split], cap, torch.float32)
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :split])},
                            cap=cap, cache_dtype=jnp.float32)
        _close(lg[:, 0].numpy(), jl[:, 0], 2e-4)
        np.testing.assert_allclose(lg[:, 0].numpy(), truth(split - 1).numpy(),
                                   rtol=2e-4, atol=2e-4)
        for i in range(split, 12):
            lg, cache = pm.decode(pp, cache, tt[:, i:i + 1], i)
            jl, jc = jm.decode(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                               jnp.int32(i))
            _close(lg[:, 0].numpy(), jl[:, 0], 2e-4)
            np.testing.assert_allclose(lg[:, 0].numpy(), truth(i).numpy(),
                                       rtol=5e-4, atol=5e-4,
                                       err_msg=f"{arch} step {i}")


def test_decode_from_a_bf16_cache_promotes_the_conv_state():
    """jamba (fp32 activations) decoding from zero bf16 caches: the
    reference's decode returns each Mamba ``conv`` in fp32 (the window's
    promoted dtype) from the first step on, and the port's buffer takes
    that dtype before its first write (``promote_states``). Six steps'
    logits within 5e-5 of max|ref| (bf16 K/V on both sides); a conv kept in
    bf16 leaves them 2-3e-3 apart from the second step."""
    jm, jp, pm, pp = _models("jamba-v0.1-52b")
    toks = np.random.default_rng(7).integers(0, pm.cfg.padded_vocab, (2, 6),
                                             dtype=np.int32)
    j_dec = jax.jit(jm.decode)
    cache = pm.init_cache(2, 8, torch.bfloat16, device="cpu")
    jcache = jm.init_cache(2, 8, jnp.bfloat16)
    with torch.no_grad():
        for i in range(6):
            lg, cache = pm.decode(pp, cache, _t(toks[:, i:i + 1]).long(), i)
            jl, jcache = j_dec(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                               jnp.int32(i))
            _close(lg.numpy(), jl, 5e-5)
    for name, sub in cache.items():
        if "conv" in sub:
            assert sub["conv"].dtype == torch.float32, name
            assert jcache[name]["conv"].dtype == jnp.float32, name


def test_generate_uniform_and_ragged_match_reference(fam):
    arch, jm, jp, pm, pp = fam
    lens, new = [12, 5, 9, 5], 5
    toks = np.random.default_rng(5).integers(0, pm.cfg.padded_vocab, (4, 12),
                                             dtype=np.int32)
    jeng, eng = JaxEngine(jm, jp), Engine(pm, pp, device="cpu")
    tt = _t(toks).long()
    ref = jeng.generate({"tokens": jnp.asarray(toks[:2])}, new)
    got = eng.generate({"tokens": tt[:2]}, new)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    ref = jeng.generate({"tokens": jnp.asarray(toks)}, new, prompt_lens=lens)
    got = eng.generate({"tokens": tt}, new, prompt_lens=lens)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    one = eng.generate({"tokens": tt[1:2, :5]}, new)
    np.testing.assert_array_equal(got.tokens[1, 12:].numpy(),
                                  one.tokens[0, 5:].numpy())


# ----------------------------------------------------------------------------
# the paged fleet (jamba: attention + Mamba + MoE in one step; grok: MoE)
# ----------------------------------------------------------------------------

class _ListWorkload:
    def __init__(self, requests, scenario="custom", seed=0):
        self.requests = requests
        self.scenario = scenario
        self.seed = seed


@pytest.fixture(scope="module", params=["jamba-v0.1-52b", "grok-1-314b"])
def fleet_ref(request):
    """Reduced jamba or grok, one weight set, five staggered requests (two
    decode slots, so a freed slot is re-admitted mid-stream), and the
    reference's ``Engine.generate`` stream of each."""
    arch = request.param
    jm, jp, pm, pp = _models(arch)
    rng = np.random.default_rng(0)
    reqs = [Request(i, i * 1.0, tuple(int(x) for x in rng.integers(
        0, pm.cfg.padded_vocab, size=n)), 4)
            for i, n in enumerate([6, 10, 6, 9, 10])]
    eng = JaxEngine(jm, jp)
    want = {}
    for r in reqs:
        g = eng.generate({"tokens": jnp.asarray(r.prompt, jnp.int32)[None]},
                         r.max_new)
        want[r.rid] = np.asarray(g.tokens[0, r.prompt_len:]).tolist()
    return arch, pm, pp, reqs, want


def _fleet(pm, peers, reqs, cache_dtype=torch.float32, fused=True,
           spec=None):
    fc = FleetConfig(max_slots=2, block_size=4, num_blocks=32,
                     max_blocks_per_slot=8, max_prefills_per_step=1,
                     fused_attention=fused)
    router = FleetRouter(pm, peers, config=fc, cache_dtype=cache_dtype,
                         device="cpu",
                         policy="speculative" if spec else "round_robin",
                         spec=spec)
    rep = router.run(_ListWorkload(reqs), slo_ms=50.0)
    return router, rep


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gather"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["fp32", "int8"])
def test_fleet_streams_equal_reference_engine(fleet_ref, dtype, fused):
    arch, pm, pp, reqs, want = fleet_ref
    router, rep = _fleet(pm, [pp], reqs, dtype, fused)
    assert rep.completed == len(reqs) and rep.lost_tokens == 0
    pool = router.engines[0].pool
    if arch.startswith("jamba"):
        assert set(pool.states) == {"sub0"} and set(pool.kv) == {"sub1"}
        assert pool.states["sub0"]["h"].dtype == torch.float32
        assert pool.states["sub0"]["conv"].dtype == torch.float32
    else:
        assert pool.states == {}
    assert max(len(e.records) for e in router.engines) > 2, "re-admission"
    for rec in router._primaries:
        assert rec.tokens == want[rec.request.rid], (arch, rec.request.rid)


def test_speculative_streams_grok_equal_plain_jamba_raises(fleet_ref):
    arch, pm, pp, reqs, want = fleet_ref
    spec = SpecConfig(k=3)
    if arch.startswith("jamba"):
        with pytest.raises(ValueError, match="attention-only"):
            _fleet(pm, [pp, pp], reqs, spec=spec)
        return
    router, rep = _fleet(pm, [pp, pp], reqs, spec=spec)
    assert rep.spec_drafted_tokens > 0
    assert rep.spec_accepted_tokens > 0
    for rec in router._primaries:
        assert rec.tokens == want[rec.request.rid], rec.request.rid


# ----------------------------------------------------------------------------
# training: three codist steps on the reference's weights and batches
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_three_codist_steps_match_reference(arch):
    jm, pm = jax_build_model(jax_get_reduced(arch)), build_model(
        get_reduced(arch))
    n, steps = 2, 3
    rng = np.random.default_rng(3)
    v = pm.cfg.vocab_size
    batches = []
    for _ in range(steps):
        lead = (n, 2, 16)
        batches.append({
            "tokens": rng.integers(0, v, lead).astype(np.int32),
            "labels": rng.integers(0, v, lead).astype(np.int32),
            "mask": (rng.random(lead) > 0.2).astype(np.float32)})
    kw = dict(lr=0.05, warmup_steps=0, total_steps=steps, optimizer="sgdm",
              label_smoothing=0.1, fused_losses=True)
    j_init, _ = jax_make_optimizer("sgdm")
    jstate = jax.jit(lambda k: jax_init_codist_state(jm, k, n, j_init))(
        jax.random.key(0))
    pstate = CodistState(
        trainable_params(peer_params_from_jax(_np(jstate.params), n,
                                              device="cpu")),
        opt_state_from_jax(jstate.opt, n, device="cpu"), 0)
    _js, jh = jax_train_codist(
        jm, JCodistConfig(n_models=n), JTrainConfig(**kw),
        lambda k: {a: jnp.asarray(x) for a, x in batches[k].items()},
        log_every=1, state=jstate)
    _ps, ph = train_codist(
        pm, CodistConfig(n_models=n), TrainConfig(**kw),
        lambda k: {a: _t(x) for a, x in batches[k].items()},
        log_every=1, state=pstate, device="cpu")
    assert len(ph.records) == len(jh.records) == steps
    for jr, pr in zip(jh.records, ph.records):
        for key in ("loss", "task_loss", "distill_loss", "aux_loss",
                    "comm_bytes"):
            _close_rel(pr[key], jr[key])
    assert ph.records[0]["aux_loss"] > 0


def test_allreduce_steps_carry_aux_as_reference():
    """The all-reduce baseline on grok-1: ``task + aux`` is the total and
    the metrics carry both, as the reference's ``AllReduce.loss``."""
    jm, pm = jax_build_model(jax_get_reduced("grok-1-314b")), build_model(
        get_reduced("grok-1-314b"))
    kw = dict(lr=0.05, warmup_steps=0, total_steps=3, optimizer="sgdm",
              label_smoothing=0.1, fused_losses=True)
    j_init, _ = jax_make_optimizer("sgdm")
    jstate = jax.jit(lambda k: jax_init_train_state(jm, k, j_init))(
        jax.random.key(0))
    pstate = TrainState(trainable_params(params_from_jax(
        _np(jstate.params), device="cpu")), opt_state_from_jax(
            jstate.opt, device="cpu"), 0)
    jb = jax_build_train_step(jm, JTrainConfig(**kw), None, JAllReduce())
    pb = build_train_step(pm, TrainConfig(**kw), None, AllReduce())
    rng = np.random.default_rng(6)
    v = pm.cfg.vocab_size
    for k in range(3):
        batch = {"tokens": rng.integers(0, v, (2, 16)).astype(np.int32),
                 "labels": rng.integers(0, v, (2, 16)).astype(np.int32),
                 "mask": (rng.random((2, 16)) > 0.2).astype(np.float32)}
        jstate, jmet, _ = jb.apply(
            jstate, {a: jnp.asarray(x) for a, x in batch.items()}, k)
        pstate, pmet, _ = pb.apply(
            pstate, {a: _t(x) for a, x in batch.items()}, k)
        for key in ("loss", "task_loss", "aux_loss"):
            _close_rel(float(pmet[key]), float(jmet[key]))
        assert float(pmet["aux_loss"]) > 0
        _close_rel(float(pmet["loss"]),
                   float(pmet["task_loss"]) + float(pmet["aux_loss"]))


@pytest.mark.parametrize("case", ["no-buffer", "sliced"])
def test_sgd_update_without_buffer_and_in_slices(case, monkeypatch):
    """The full-width grok-1 training's optimizer: plain SGD from a state
    without a buffer equals momentum 0 with one (and refuses a momentum),
    and a leaf updated in flat slices equals one updated whole, bit for
    bit (bf16 leaves, a mask of numbers)."""
    from repro_torch.optim import OptState
    from repro_torch.optim import optimizers as opt
    rng = np.random.default_rng(4)

    def tree():
        return {"w": torch.from_numpy(rng.standard_normal((3, 50, 7)).astype(
            np.float32)).to(torch.bfloat16),
                "b": torch.from_numpy(rng.standard_normal(5).astype(
                    np.float32)).to(torch.bfloat16)}
    params, grads = tree(), tree()
    ref = {k: v.clone() for k, v in params.items()}
    opt.sgdm_update(ref, grads, opt.sgdm_init(ref, torch.bfloat16), 0.1,
                    0.01, momentum=0.0)
    got = {k: v.clone() for k, v in params.items()}
    if case == "no-buffer":
        _p, st = opt.sgdm_update(got, grads, OptState(0, None, None), 0.1,
                                 0.01, momentum=0.0)
        assert st.m is None and st.step == 1
        with pytest.raises(ValueError, match="momentum buffer"):
            opt.sgdm_update(got, grads, OptState(0, None, None), 0.1)
    else:
        monkeypatch.setattr(opt, "_SLICE", 64)
        opt.sgdm_update(got, grads, opt.sgdm_init(got, torch.bfloat16), 0.1,
                        0.01, momentum=0.0, trainable={"w": 1, "b": 1})
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


# ----------------------------------------------------------------------------
# checkpoints, the serving cast, configs, refusals
# ----------------------------------------------------------------------------

def test_jamba_checkpoint_round_trips_with_the_reference(tmp_path):
    """A full 8-sub-layer jamba step (sub0 .. sub7: seven Mamba mixers and
    one attention, four MoE FFNs) at reduced width: the port's tree has the
    reference's leaves, and each side loads what the other saved."""
    over = dict(attn_layer_period=8, num_layers=8)
    like = jax.eval_shape(
        jax_build_model(replace(jax_get_reduced("jamba-v0.1-52b"),
                                **over)).init, jax.random.key(0))
    gen = torch.Generator()
    gen.manual_seed(3)
    pp = build_model(replace(get_reduced("jamba-v0.1-52b"), **over)).init(
        gen, device="cpu")
    want = params_to_numpy(pp)
    assert {p: (tuple(t.shape), str(t.dtype)) for p, t in _flat(want)} == {
        tuple(k.key for k in p): (tuple(a.shape), str(a.dtype))
        for p, a in jax.tree_util.tree_flatten_with_path(like)[0]}
    assert sorted(want["layers"]) == [f"sub{i}" for i in range(8)]
    save_pytree(str(tmp_path / "port"), want)
    loaded = jax_load_pytree(str(tmp_path / "port"), like)
    for path, a in jax.tree_util.tree_flatten_with_path(loaded)[0]:
        got = want
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(np.asarray(a), got, err_msg=str(path))
    jax_save_pytree(str(tmp_path / "ref"), loaded)
    back = load_pytree(str(tmp_path / "ref"), pp)
    for (path, a), (_p, b) in zip(_flat(back), _flat(pp)):
        assert torch.equal(a, b), path
    cast = serving_params(pp, torch.bfloat16)
    for path, t in _flat(cast):
        fp32 = path[-1] in ("router", "dt_bias", "A_log", "D") or (
            path[-1] == "scale" and "norm" in path[-2])
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), path


def test_configs_equal_the_reference():
    for arch in ARCHS:
        for get, jget in ((get_config, None), (get_reduced, jax_get_reduced)):
            pc = get(arch)
            if jget is not None:
                jc = jget(arch)
                assert pc.moe.num_experts == jc.moe.num_experts == 4
                assert (pc.num_layers, pc.attn_layer_period) == (
                    jc.num_layers, jc.attn_layer_period)
            assert type(build_model(pc)).__name__ == "LM"
    red = get_reduced("jamba-v0.1-52b")
    assert (red.attn_layer_period, red.num_layers) == (2, 2)
    full = get_config("jamba-v0.1-52b")
    assert [full.layer_kind(i) for i in range(8)] == ["ssm"] * 7 + ["attn"]
    assert [full.is_moe_layer(i) for i in range(8)] == [False, True] * 4


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "internvl2-76b",
                                  "whisper-tiny"])
def test_other_families_still_refuse(arch):
    """Every family is ported now (rwkv6: tests/test_torch_rwkv.py; the VLM
    and audio archs: tests/test_torch_vlm_serve.py): the full and reduced
    configs are the reference's, field by field, and build the reference's
    model class."""
    import dataclasses
    for mine, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_reduced(arch), jax_get_reduced(arch))):
        names = [f.name for f in dataclasses.fields(ref)]
        assert names == [f.name for f in dataclasses.fields(mine)]
        for name in names:
            a, b = getattr(mine, name), getattr(ref, name)
            if dataclasses.is_dataclass(b):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, name
        assert (type(build_model(mine)).__name__
                == type(jax_build_model(ref)).__name__)
