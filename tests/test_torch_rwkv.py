"""rwkv6 (the attention-free ``ssm`` family) on the port, held against the
JAX reference on the CPU at the reduced size, on the reference's weights
carried across by the bridge and inputs made with numpy.

* The WKV recurrence: ``rwkv_wkv_chunked`` equals ``rwkv_wkv_sequential``
  and the reference's chunked form at one and two chunks of 64, at a length
  off the chunk (where both sides take the sequential scan) and from a
  carried state ``s0``, within 1e-5 of max|ref|.
* The time mix and the channel mix of layer 0, continuing from shift
  carries and a WKV state, against the reference's (outputs, carries and
  final state).
* The reduced LM: the tree equals the reference's leaf for leaf, the
  forward is within 1e-4 of max|ref|; prefill (on and off the chunk) and
  decode logits against the reference's and the teacher-forced forward;
  the serving cast keeps the leaves the reference reads in fp32.
* ``Engine.generate`` uniform and ragged equal to the reference's, ragged
  equal to per-request generation.
* The paged fleet over fp32 and int8 pools: a pool with no attention
  sub-layer (no block pools, fp32 states, none of the paged kernels
  reached) whose streams equal the reference's ``Engine.generate``, with a
  re-admitted slot (the reference's ``test_fleet.py`` holds rwkv6 so).
* Three ``train_codist`` steps within 1e-5 relative, and the training CLI
  on ``--arch rwkv6-1.6b``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CodistConfig as JCodistConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.models import rwkv as jrk
from repro.optim import make_optimizer as jax_make_optimizer
from repro.serve import Engine as JaxEngine
from repro.train import train_codist as jax_train_codist
from repro.train.state import init_codist_state as jax_init_codist_state
from repro_torch.checkpoint import (opt_state_from_jax, params_from_jax,
                                    peer_params_from_jax, serving_params)
from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
from repro_torch.models import build_model
from repro_torch.models import rwkv as rk
from repro_torch.serve import Engine
from repro_torch.serve.fleet import FleetConfig, FleetRouter, Request
from repro_torch.train import train_codist
from repro_torch.train.state import CodistState, trainable_params

ARCH = "rwkv6-1.6b"


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


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def lm():
    """The reduced rwkv6 on both sides with one set of bridged weights and
    one reference engine (its jits built once for the module)."""
    jm = jax_build_model(jax_get_reduced(ARCH))
    jp = jax.jit(jm.init)(jax.random.key(1))
    pm = build_model(get_reduced(ARCH))
    return jm, jp, pm, params_from_jax(_np(jp), device="cpu"), JaxEngine(jm,
                                                                          jp)


# ----------------------------------------------------------------------------
# the WKV recurrence
# ----------------------------------------------------------------------------

def _wkv_inputs(length, s0, b=2, h=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, length, h, hd)).astype(np.float32)
               for _ in range(3))
    raw = rng.uniform(-6.0, 0.5, (b, length, h, hd)).astype(np.float32)
    w = np.exp(-np.exp(raw)).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, hd))).astype(np.float32)
    s = (rng.standard_normal((b, h, hd, hd)).astype(np.float32)
         if s0 else None)
    return r, k, v, w, u, s


@pytest.mark.parametrize("length,s0", [(64, False), (128, False),
                                       (40, False), (128, True)],
                         ids=["one-chunk", "two-chunks", "off-chunk",
                              "two-chunks-s0"])
def test_wkv_forms_match_reference(length, s0):
    args = _wkv_inputs(length, s0)
    jy, js = jax.jit(lambda *a: jrk.rwkv_wkv_chunked(*a[:5], chunk=64,
                                                     s0=a[5]))(*args)
    targs = [None if a is None else _t(a) for a in args]
    cy, cs = rk.rwkv_wkv_chunked(*targs[:5], chunk=64, s0=targs[5])
    sy, ss = rk.rwkv_wkv_sequential(*targs)
    for y, s in ((cy, cs), (sy, ss)):
        _close(y.numpy(), jy, 1e-5)
        _close(s.numpy(), js, 1e-5)
    if length % 64:
        # off the chunk both forms ARE the sequential scan
        assert torch.equal(cy, sy) and torch.equal(cs, ss)


def test_time_and_channel_mix_carries_match_reference(lm):
    """Layer 0's mixes continuing a sequence: shift carries and a WKV state
    in, (out, last x, final state) out, over 64 tokens (the chunked form
    from s0) and 3 (the sequential one)."""
    _jm, jp, pm, pp, _je = lm
    cfg, jcfg = pm.cfg, jax_get_reduced(ARCH)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["sub0"])
    tl = {k: {n: t[0] for n, t in v.items()} if isinstance(v, dict) else v[0]
          for k, v in pp["layers"]["sub0"].items()}
    h, hd, _ = rk._dims(cfg)
    rng = np.random.default_rng(2)
    for length in (64, 3):
        x = rng.standard_normal((2, length, cfg.d_model)).astype(np.float32)
        prev = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        s0 = (0.1 * rng.standard_normal((2, h, hd, hd))).astype(np.float32)
        jo, (jlast, js) = jrk.time_mix_forward(
            jl["mix"], jnp.asarray(x), jcfg, shift_prev=jnp.asarray(prev),
            s0=jnp.asarray(s0))
        with torch.no_grad():
            o, (last, s) = rk.time_mix_forward(tl["mix"], _t(x), cfg,
                                               shift_prev=_t(prev), s0=_t(s0))
        _close(o.numpy(), jo, 1e-5)
        _close(s.numpy(), js, 1e-5)
        np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
        jo, jlast = jrk.channel_mix_forward(jl["ffn"], jnp.asarray(x), jcfg,
                                            shift_prev=jnp.asarray(prev))
        with torch.no_grad():
            o, last = rk.channel_mix_forward(tl["ffn"], _t(x), cfg,
                                             shift_prev=_t(prev))
        _close(o.numpy(), jo, 1e-5)
        np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


# ----------------------------------------------------------------------------
# the LM: tree, forward, prefill + decode, the serving cast
# ----------------------------------------------------------------------------

def test_lm_forward_and_tree_match_reference(lm):
    jm, jp, pm, pp, _je = lm
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = {p: (tuple(t.shape), str(t.dtype)[6:])
            for p, t in _flat(pm.init(gen, device="cpu"))}
    ref = {tuple(k.key for k in p): (tuple(a.shape), str(a.dtype))
           for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert mine == ref
    assert ("embed_norm", "scale") in mine
    toks = np.random.default_rng(7).integers(0, pm.cfg.padded_vocab, (2, 128),
                                             dtype=np.int32)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        pl, pa = pm.forward(pp, {"tokens": _t(toks).long()})
    _close(pl.numpy(), jl, 1e-4)
    assert float(pa) == 0.0
    cast = serving_params(pp, torch.bfloat16)
    for path, t in _flat(cast):
        fp32 = path[-1] in ("decay_base", "bonus", "ln_x_scale",
                            "ln_x_bias") or (path[-1] == "scale"
                                             and "norm" in path[-2])
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), path


@pytest.mark.parametrize("split", [64, 9], ids=["on-chunk", "off-chunk"])
def test_prefill_and_decode_match_reference(lm, split):
    """Prefill ``split`` tokens (the chunked form at 64, the sequential
    scan at 9), then 4 decode steps: each step's logits within 1e-4 of
    max|ref| of the reference's and within 5e-4 of the teacher-forced
    forward; the cache's dtypes are the reference's."""
    jm, jp, pm, pp, _je = lm
    n = split + 4
    toks = np.random.default_rng(8).integers(0, pm.cfg.padded_vocab, (2, n),
                                             dtype=np.int32)
    tt = _t(toks).long()
    with torch.no_grad():
        truth = pm.forward(pp, {"tokens": tt})[0]
        lg, cache = pm.prefill(pp, tt[:, :split], n, torch.float32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :split])}, cap=n,
                        cache_dtype=jnp.float32)
    _close(lg[:, 0].numpy(), jl[:, 0], 1e-4)
    sub = cache["sub0"]
    assert set(sub) == {"s", "shift_tm", "shift_cm"}
    assert sub["s"].dtype == torch.float32
    _close(sub["s"].numpy(), jc["sub0"]["s"], 1e-5)
    j_dec = jax.jit(jm.decode)
    for i in range(split, n):
        with torch.no_grad():
            lg, cache = pm.decode(pp, cache, tt[:, i:i + 1], i)
        jl, jc = j_dec(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        _close(lg[:, 0].numpy(), jl[:, 0], 1e-4)
        np.testing.assert_allclose(lg[:, 0].numpy(), truth[:, i].numpy(),
                                   rtol=5e-4, atol=5e-4, err_msg=f"step {i}")


def test_generate_uniform_and_ragged_match_reference(lm):
    _jm, _jp, pm, pp, jeng = lm
    lens, new = [9, 5, 9, 5], 5
    toks = np.random.default_rng(5).integers(0, pm.cfg.padded_vocab, (4, 9),
                                             dtype=np.int32)
    eng = Engine(pm, pp, device="cpu")
    tt = _t(toks).long()
    ref = jeng.generate({"tokens": jnp.asarray(toks[:2])}, new)
    got = eng.generate({"tokens": tt[:2]}, new)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    ref = jeng.generate({"tokens": jnp.asarray(toks)}, new, prompt_lens=lens)
    got = eng.generate({"tokens": tt}, new, prompt_lens=lens)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    for r in (1, 2):
        one = eng.generate({"tokens": tt[r:r + 1, :lens[r]]}, new)
        np.testing.assert_array_equal(got.tokens[r, 9:].numpy(),
                                      one.tokens[0, lens[r]:].numpy())


# ----------------------------------------------------------------------------
# the paged fleet: no attention sub-layer, so no block pools
# ----------------------------------------------------------------------------

class _ListWorkload:
    def __init__(self, requests, scenario="custom", seed=0):
        self.requests = requests
        self.scenario = scenario
        self.seed = seed


@pytest.fixture(scope="module")
def fleet_ref(lm):
    """Five staggered requests (two decode slots, so a freed slot is
    re-admitted mid-stream; one prompt of 64, the chunked prefill) and the
    reference's ``Engine.generate`` stream of each."""
    _jm, _jp, pm, _pp, jeng = lm
    rng = np.random.default_rng(0)
    reqs = [Request(i, i * 1.0, tuple(int(x) for x in rng.integers(
        0, pm.cfg.padded_vocab, size=n)), 4)
            for i, n in enumerate([5, 9, 64, 9, 5])]
    want = {}
    for r in reqs:
        g = jeng.generate({"tokens": jnp.asarray(r.prompt, jnp.int32)[None]},
                          r.max_new)
        want[r.rid] = np.asarray(g.tokens[0, r.prompt_len:]).tolist()
    return reqs, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["fp32", "int8"])
def test_fleet_streams_equal_reference_engine(lm, fleet_ref, dtype,
                                              monkeypatch):
    from repro_torch.serve.fleet import model_exec

    def unreachable(*_a, **_k):
        raise AssertionError("a paged-KV kernel was reached by a model with "
                             "no attention sub-layer")
    for name in ("paged_attention_decode", "paged_gather", "paged_scatter_kv",
                 "paged_scatter_quant_kv"):
        monkeypatch.setattr(model_exec, name, unreachable)
    _jm, _jp, pm, pp, _je = lm
    reqs, want = fleet_ref
    fc = FleetConfig(max_slots=2, block_size=4, num_blocks=48,
                     max_blocks_per_slot=18, max_prefills_per_step=1)
    router = FleetRouter(pm, [pp], config=fc, cache_dtype=dtype,
                         device="cpu")
    rep = router.run(_ListWorkload(reqs), slo_ms=50.0)
    assert rep.completed == len(reqs) and rep.lost_tokens == 0
    assert rep.kv_bytes_written == 0
    pool = router.engines[0].pool
    assert pool.kv == {} and set(pool.states) == {"sub0"}
    assert pool.states["sub0"]["s"].dtype == torch.float32
    assert pool.states["sub0"]["shift_tm"].dtype == torch.float32
    assert max(len(e.records) for e in router.engines) > 2, "re-admission"
    for rec in router._primaries:
        assert rec.tokens == want[rec.request.rid], rec.request.rid


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------

def test_three_codist_steps_match_reference():
    jm, pm = jax_build_model(jax_get_reduced(ARCH)), build_model(
        get_reduced(ARCH))
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
        for key in ("loss", "task_loss", "distill_loss", "comm_bytes"):
            _close_rel(pr[key], jr[key])


def test_train_cli_runs_rwkv6(capsys):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--arch", ARCH, "--steps", "2", "--batch", "2",
          "--seq", "16", "--log-every", "1", "--eval-every", "100"])
    assert "done: 2 steps" in capsys.readouterr().out
