"""The port's peer-speculative decoding held against the JAX reference and
against its own plain decode, on the CPU.

* ``write_maps_k``, ``snapshot_rows`` and ``restore_rows`` equal the
  reference pool's on the same prefilled pool, and a restore after the
  rows were overwritten is bit-exact on fp32, int8 and fp8 pools.
* ``build_verify_step`` (reduced qwen2-7b, GQA G = 2) equals k sequential
  plain decodes of the port, and the reference's ``build_verify_step`` on
  bridged weights and the same pool and tokens, on the fused and the
  gather path: argmax equal and within 2e-4, and the pool it leaves within
  1e-5.
* Speculative streams equal the reference's plain ``Engine.generate``
  streams (identical peers, a noised student draft, a dedicated draft
  peer, the draft partner preempted), and a run full of rejected drafts
  leaves the pools bit-identical to a plain run's.

The reference's Pallas scatters do not trace on every installed JAX
(``pl.load``), so its pool tests run with the jnp oracles swapped in by
``monkeypatch``; nothing of the JAX package changes.
"""
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.kernels import paged_cache as jax_paged_cache
from repro.models import build_model as jax_build_model
from repro.serve import Engine
from repro.serve.fleet import model_exec as jax_model_exec
from repro.serve.fleet.cache import PagedCachePool as JaxPagedCachePool
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.runtime import FaultConfig
from repro_torch.serve.fleet import (ChaosConfig, FleetConfig, FleetDefense,
                                     FleetRouter, PagedCachePool, Request,
                                     SpecConfig, SpecEngine,
                                     generate_workload)
from repro_torch.serve.fleet.model_exec import (build_decode_step,
                                                build_verify_step)

torch.set_num_threads(2)

DTYPES = [(torch.float32, jnp.float32), (torch.int8, jnp.int8),
          (torch.float8_e4m3fn, jnp.float8_e4m3fn)]
DTYPE_IDS = ["fp32", "int8", "fp8"]
LENS = [5, 9, 12, 7, 5, 9, 12, 7]
MAX_NEW = 6
_FC = dict(max_slots=2, block_size=4, num_blocks=32, max_blocks_per_slot=8,
           max_prefills_per_step=1)


def _tiny_cfg(get):
    """The reference ``test_spec.py``'s tiny model."""
    return replace(get("qwen1.5-0.5b"), num_layers=2, d_model=64, d_ff=128,
                   vocab_size=64, num_heads=2, num_kv_heads=2, head_dim=32)


class _ListWorkload:
    def __init__(self, requests, scenario="custom", seed=0):
        self.requests = requests
        self.scenario = scenario
        self.seed = seed


def _requests(vocab, lens=LENS, max_new=MAX_NEW, gap_ms=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(i, i * gap_ms, tuple(int(x) for x in
                                         rng.integers(0, vocab, size=n)),
                    max_new)
            for i, n in enumerate(lens)]


def _bits(t) -> np.ndarray:
    """A tensor's or array's bits (numpy has no fp8)."""
    if isinstance(t, torch.Tensor):
        if t.element_size() == 1:
            return t.view(torch.uint8).numpy()
        return t.numpy().view(np.int32)
    a = np.asarray(t)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.int32)


def _noised(params, scale, seed=42):
    """A deterministically perturbed copy: a student draft that agrees with
    the target on some argmaxes, not all (numpy noise, one stream a
    leaf)."""
    def leaf(t, i=[0]):
        i[0] += 1
        rng = np.random.default_rng(seed + i[0])
        return t + scale * torch.from_numpy(
            rng.standard_normal(tuple(t.shape)).astype(np.float32)).to(t.dtype)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return leaf(tree)
    return walk(params)


@pytest.fixture(scope="module")
def tiny():
    """The tiny model on both sides with one set of bridged weights, and
    the reference's ``Engine.generate`` stream of every request of
    ``_requests`` (4 prompt lengths trace once each)."""
    jm = jax_build_model(_tiny_cfg(jax_get_reduced))
    jp = jm.init(jax.random.key(0))
    pm = build_model(_tiny_cfg(get_reduced))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    reqs = _requests(pm.cfg.padded_vocab)
    eng = Engine(jm, jp)
    want = {}
    for r in reqs:
        g = eng.generate({"tokens": jnp.asarray(r.prompt, jnp.int32)[None]},
                         r.max_new)
        want[r.rid] = np.asarray(g.tokens[0, r.prompt_len:]).tolist()
    return jm, jp, pm, pp, reqs, want


def _streams(router):
    return {r.request.rid: r.tokens for r in router._primaries}


# ----------------------------------------------------------------------------
# the undo log and the k-token write maps
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=DTYPE_IDS)
def test_undo_log_equals_reference_and_restores_bits(tiny, dtype, jdtype):
    """The same prefill caches in both pools: the k-token write maps and
    the snapshot rows equal the reference's; rows overwritten through the
    maps then restored from the snapshot leave every pool bit-identical
    (payload and scales), also when only a suffix is restored."""
    jm, _jp, pm, _pp, _r, _w = tiny
    kw = dict(max_slots=3, block_size=4, num_blocks=16, max_blocks_per_slot=4)
    ref = JaxPagedCachePool(jm, cache_dtype=jdtype, **kw)
    mine = PagedCachePool(pm, cache_dtype=dtype, device="cpu", **kw)
    cfg = pm.cfg
    rng = np.random.default_rng(7)
    for slot, (n, total) in enumerate([(5, 10), (3, 6), (14, 16)]):
        cache = {f"sub{i}": {
            name: (rng.standard_normal((cfg.num_layers, 1, n, cfg.num_kv_heads,
                                        cfg.resolved_head_dim)) * 2
                   ).astype(np.float32) for name in ("k", "v")}
            for i in mine.kv_subs}
        for pool in (ref, mine):
            pool.allocate(slot, total)
        ref.insert_prefill(slot, jax.tree.map(jnp.asarray, cache), n)
        mine.insert_prefill(slot, jax.tree.map(torch.from_numpy, cache), n)
    active = np.array([True, True, True])
    k = 4
    for a, b in zip(ref.write_maps_k(active, k), mine.write_maps_k(active, k)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    wslots, woffs = mine.write_maps_k(active, k)
    assert (wslots[2:, :] != 2).all(), "slot 2 has room for 2 positions only"

    before = {s: {n: t.clone() for n, t in d.items()}
              for s, d in mine.kv.items()}
    for slot in range(3):
        base = int(mine.lengths[slot])
        jb, jo, jdata = ref.snapshot_rows(slot, base, k)
        mb, mo, mdata = mine.snapshot_rows(slot, base, k)
        assert np.array_equal(jb, mb) and np.array_equal(jo, mo)
        for sub, d in mdata.items():
            assert set(d) == set(jdata[sub])
            for name, t in d.items():
                assert np.array_equal(_bits(t.view(mine.kv[sub][name].dtype)),
                                      _bits(jdata[sub][name])), (sub, name)
    snaps = {s: mine.snapshot_rows(s, int(mine.lengths[s]), k)
             for s in range(3)}
    for j in range(k):
        for blk in np.nonzero(wslots[j] >= 0)[0]:
            for d in mine.kv.values():
                for t in d.values():
                    if t.element_size() == 1:
                        t.view(torch.uint8)[:, blk, woffs[j, blk]] = 0x3c
                    else:
                        t[:, blk, woffs[j, blk]] = 3.0
    assert any(not torch.equal(t.view(torch.uint8),
                               before[s][n].view(torch.uint8))
               for s, d in mine.kv.items() for n, t in d.items())
    mine.restore_rows(snaps[0], start=0)
    mine.restore_rows(snaps[1], start=2)     # the suffix of a 2-token accept
    mine.restore_rows(snaps[1], start=0)     # then the rest
    mine.restore_rows(snaps[2], start=1)
    mine.restore_rows(snaps[2], start=0)
    for s, d in mine.kv.items():
        for n, t in d.items():
            assert torch.equal(t.view(torch.uint8),
                               before[s][n].view(torch.uint8)), (s, n)


# ----------------------------------------------------------------------------
# the verify step: one batched k-token forward == k sequential decodes
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gather"])
def test_verify_matches_sequential_decode(fused):
    """Position j of the port's verify equals the port's j'th plain decode
    (argmax equal, within 2e-4), and the pool it leaves matches, over
    reduced qwen2-7b (GQA, G = 2) with one slot short of its k rows."""
    cfg = get_reduced("qwen2-7b")
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen, device="cpu")
    k = 3
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.padded_vocab, size=n) for n in (5, 9, 14)]
    toks = rng.integers(0, cfg.padded_vocab, size=(3, k))
    caps = [len(prompts[0]) + k + 1, len(prompts[1]) + k + 1, 16]

    def fresh_pool():
        pool = PagedCachePool(model, max_slots=3, block_size=4, num_blocks=16,
                              max_blocks_per_slot=4, device="cpu")
        for s, p in enumerate(prompts):
            pool.allocate(s, caps[s])
            _, cache = model.prefill(params, torch.as_tensor(p)[None],
                                     len(p))
            pool.insert_prefill(s, cache, len(p))
        return pool

    pool = fresh_pool()
    decode = build_decode_step(model, fused_attention=fused)
    seq = []
    for j in range(k):
        active = np.asarray([int(pool.lengths[s]) < caps[s] for s in range(3)])
        wslot, woff = pool.write_maps(active)
        seq.append(decode(params, pool.kv, torch.as_tensor(pool.table),
                          torch.as_tensor(pool.lengths),
                          torch.as_tensor(wslot), torch.as_tensor(woff),
                          torch.as_tensor(toks[:, j:j + 1])))
        pool.lengths[active] += 1

    pool2 = fresh_pool()
    verify = build_verify_step(model, k, fused_attention=fused)
    wslots, woffs = pool2.write_maps_k(np.ones(3, bool), k)
    vlg = verify(params, pool2.kv, torch.as_tensor(pool2.table),
                 torch.as_tensor(pool2.lengths), torch.as_tensor(wslots),
                 torch.as_tensor(woffs), torch.as_tensor(toks))
    assert vlg.shape == (3, k, cfg.padded_vocab)
    for j in range(k):
        rows = [s for s in range(3) if int(pool2.lengths[s]) + j < caps[s]]
        assert torch.equal(vlg[rows, j].argmax(-1), seq[j][rows].argmax(-1))
        torch.testing.assert_close(vlg[rows, j], seq[j][rows], atol=2e-4,
                                   rtol=0)
    for sub, d in pool.kv.items():
        for name, t in d.items():
            torch.testing.assert_close(pool2.kv[sub][name], t, atol=1e-5,
                                       rtol=0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gather"])
def test_verify_equals_reference_verify(monkeypatch, fused):
    """The port's verify against the reference's ``build_verify_step``
    (its scatters swapped for their jnp oracles) on bridged reduced
    qwen2-7b weights, over the same prefilled pool, write maps and draft
    tokens: argmax equal and within 2e-4 at every position, and the pools
    they leave within 1e-5."""
    monkeypatch.setattr(jax_model_exec, "paged_scatter",
                        jax_paged_cache.paged_scatter_ref)
    monkeypatch.setattr(jax_model_exec, "paged_scatter_quant",
                        jax_paged_cache.paged_scatter_quant_ref)
    jm = jax_build_model(jax_get_reduced("qwen2-7b"))
    jp = jm.init(jax.random.key(0))
    pm = build_model(get_reduced("qwen2-7b"))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    k = 3
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, pm.cfg.padded_vocab, size=n)
               for n in (5, 9, 14)]
    toks = rng.integers(0, pm.cfg.padded_vocab, size=(3, k))
    kw = dict(max_slots=3, block_size=4, num_blocks=16, max_blocks_per_slot=5)
    ref = JaxPagedCachePool(jm, cache_dtype=jnp.float32, **kw)
    mine = PagedCachePool(pm, device="cpu", **kw)
    for s, p in enumerate(prompts):
        _, cache = jm.prefill(jp, {"tokens": jnp.asarray(p, jnp.int32)[None]},
                              len(p), cache_dtype=jnp.float32)
        for pool in (ref, mine):
            pool.allocate(s, len(p) + k + 1)
        ref.insert_prefill(s, cache, len(p))
        mine.insert_prefill(s, jax.tree.map(
            lambda a: torch.from_numpy(np.array(a)), cache), len(p))
    active = np.ones(3, bool)
    maps = ref.write_maps_k(active, k)
    for a, b in zip(maps, mine.write_maps_k(active, k)):
        assert np.array_equal(a, b)
    assert np.array_equal(ref.table, mine.table)
    assert np.array_equal(ref.lengths, mine.lengths)

    jverify = jax_model_exec.build_verify_step(jm, k, fused_attention=fused)
    jlg, jkv, _ = jverify(jp, ref.kv, ref.states, jnp.asarray(ref.table),
                          jnp.asarray(ref.lengths), *map(jnp.asarray, maps),
                          jnp.asarray(toks, jnp.int32))
    verify = build_verify_step(pm, k, fused_attention=fused)
    vlg = verify(pp, mine.kv, *(torch.as_tensor(x) for x in (
        mine.table, mine.lengths, *maps, toks))).numpy()
    jlg = np.asarray(jlg)
    for j in range(k):
        np.testing.assert_array_equal(vlg[:, j].argmax(-1),
                                      jlg[:, j].argmax(-1))
        np.testing.assert_allclose(vlg[:, j], jlg[:, j], atol=2e-4, rtol=0)
    for sub, d in mine.kv.items():
        for name, t in d.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jkv[sub][name]),
                                       atol=1e-5, rtol=0)


def test_verify_rejects_recurrent_models():
    """An rwkv-family config (the port has no recurrent model to build yet,
    so a stand-in carries its config) raises before any step exists."""
    model = SimpleNamespace(cfg=replace(get_reduced("qwen2-7b"),
                                        family="ssm"))
    with pytest.raises(ValueError, match="attention-only"):
        build_verify_step(model, 4)


# ----------------------------------------------------------------------------
# speculative streams == the reference's plain decode
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gather"])
def test_spec_identical_peers_equal_reference_streams(tiny, fused):
    """Ring-paired identical peers: every draft accepted, and every stream
    equals the reference's ``Engine.generate``."""
    _jm, _jp, pm, pp, reqs, want = tiny
    fc = FleetConfig(**_FC, fused_attention=fused)
    router = FleetRouter(pm, [pp, pp], config=fc, policy="speculative",
                         spec=SpecConfig(k=4), device="cpu")
    rep = router.run(_ListWorkload(list(reqs)))
    assert rep.completed == len(reqs)
    assert _streams(router) == want
    assert rep.spec_accept_rate == 1.0 and rep.spec_rounds > 0
    assert rep.spec_fallback_ticks == 0
    assert rep.spec_accepted_tokens == rep.spec_drafted_tokens > 0
    assert rep.lost_tokens == 0 and rep.duplicated_tokens == 0


def test_spec_noised_student_equals_reference_streams(tiny):
    """A disagreeing draft changes nothing: the target resamples every
    divergence from its verify logits; 0 < accept rate < 1 shows both
    branches ran."""
    _jm, _jp, pm, pp, reqs, want = tiny
    router = FleetRouter(pm, [pp], config=FleetConfig(**_FC),
                         policy="speculative", spec=SpecConfig(k=4),
                         draft_model=pm, draft_params=_noised(pp, 1e-3),
                         device="cpu")
    rep = router.run(_ListWorkload(list(reqs)))
    assert _streams(router) == want
    assert 0.0 < rep.spec_accept_rate < 1.0


def test_spec_dedicated_draft_peer_equals_reference_streams(tiny):
    """A dedicated draft peer serves nothing, the others speculate on it;
    the streams are the reference's plain ones. (The reference's own case is
    red on the project's test run, so the streams are held to
    ``Engine.generate``.)"""
    _jm, _jp, pm, pp, reqs, want = tiny
    router = FleetRouter(pm, [pp, pp, pp], config=FleetConfig(**_FC),
                         policy="speculative",
                         spec=SpecConfig(k=2, draft_peer=1), device="cpu")
    rep = router.run(_ListWorkload(list(reqs)))
    assert rep.completed == len(reqs)
    assert _streams(router) == want
    drafter = router.engines[1]
    assert not isinstance(drafter, SpecEngine) and not drafter.records
    assert all(isinstance(router.engines[i], SpecEngine) for i in (0, 2))
    assert all(router.engines[i].partner is drafter for i in (0, 2))


def test_spec_fallback_when_partner_preempted(tiny):
    """The draft partner preempted mid-run forces plain fallback ticks;
    speculation resumes after the in-flight slots drain, nothing is lost or
    duplicated, and the streams equal a plain fleet's under the same faults
    (the reference's case is red on the project's test run)."""
    _jm, _jp, pm, pp, _reqs, _want = tiny
    wl = generate_workload("steady", 12, pm.cfg.padded_vocab, seed=5,
                           max_prompt=12, max_new=6)
    chaos = ChaosConfig(FaultConfig(n_peers=2, seed=5,
                                    preemptions=((1, 6, 120.0),)))
    fc = FleetConfig(**_FC)
    spec = FleetRouter(pm, [pp, pp], config=fc, policy="speculative",
                       spec=SpecConfig(k=4), chaos=chaos,
                       defense=FleetDefense(), device="cpu")
    rep = spec.run(wl)
    assert rep.preemptions >= 1
    assert rep.spec_fallback_ticks >= 1 and rep.spec_rounds >= 1
    assert rep.completed == 12
    assert rep.lost_tokens == 0 and rep.duplicated_tokens == 0
    plain = FleetRouter(pm, [pp, pp], config=fc, device="cpu").run(wl)
    assert rep.stream_digest == plain.stream_digest


def test_spec_needs_two_peers_for_the_ring(tiny):
    _jm, _jp, pm, pp, _r, _w = tiny
    with pytest.raises(ValueError, match="2 peers"):
        FleetRouter(pm, [pp], policy="speculative", device="cpu")


# ----------------------------------------------------------------------------
# rollback: the pools end bit-identical to a never-drafted run's
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [d for d, _ in DTYPES], ids=DTYPE_IDS)
def test_spec_rollback_pool_bit_identity(tiny, dtype):
    """Two waves reusing the same blocks, a student that disagrees often:
    the target pool (payload and scale bits, table, lengths, free list)
    equals a plain run's, and so do the streams."""
    _jm, _jp, pm, pp, _r, _w = tiny
    vocab = pm.cfg.padded_vocab
    wave1 = _requests(vocab, [5, 9], gap_ms=0.0)
    wave2 = [Request(10 + i, 1000.0, r.prompt, r.max_new)
             for i, r in enumerate(_requests(vocab, [12, 7], seed=3))]
    reqs = wave1 + wave2
    fc = FleetConfig(**_FC)
    plain = FleetRouter(pm, [pp], config=fc, cache_dtype=dtype, device="cpu")
    rp = plain.run(_ListWorkload(list(reqs)))
    spec = FleetRouter(pm, [pp], config=fc, cache_dtype=dtype,
                       policy="speculative", spec=SpecConfig(k=4),
                       draft_model=pm, draft_params=_noised(pp, 1e-2),
                       device="cpu")
    rs = spec.run(_ListWorkload(list(reqs)))
    assert rs.stream_digest == rp.stream_digest
    assert rs.spec_accept_rate < 1.0
    a, b = plain.engines[0].pool, spec.engines[0].pool
    assert np.array_equal(a.table, b.table)
    assert np.array_equal(a.lengths, b.lengths)
    assert a.slot_blocks == b.slot_blocks and a.free == b.free
    for sub, d in a.kv.items():
        for name, t in d.items():
            assert torch.equal(_raw(t), _raw(b.kv[sub][name])), (sub, name)


def _raw(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t.view(torch.int32)


def test_spec_seeded_determinism_and_speedup(tiny):
    """Two identical speculative runs give byte-identical reports, and at
    k = 4 with full accepts the simulated tokens/s beat the plain fleet's by
    more than 1.5x in the service-bound regime, on equal streams (the
    reference's speedup case is red on the project's test run)."""
    _jm, _jp, pm, pp, _r, _w = tiny
    wl = generate_workload("steady", 16, pm.cfg.padded_vocab, seed=7,
                           max_prompt=8, max_new=16)
    reqs = [Request(r.rid, r.arrival_ms * 0.02, r.prompt, 16)
            for r in wl.requests]
    fc = FleetConfig(max_slots=4, block_size=4, num_blocks=64,
                     max_blocks_per_slot=8)

    def spec():
        return FleetRouter(pm, [pp, pp], config=fc, policy="speculative",
                           spec=SpecConfig(k=4), device="cpu").run(
            _ListWorkload(list(reqs), scenario="steady", seed=7))

    a, b = spec(), spec()
    assert a.to_json() == b.to_json()
    plain = FleetRouter(pm, [pp, pp], config=fc, device="cpu").run(
        _ListWorkload(list(reqs), scenario="steady", seed=7))
    assert a.stream_digest == plain.stream_digest
    assert a.sim_tokens_per_s / plain.sim_tokens_per_s > 1.5


def test_decode_plan_slots_fixes_the_split_plan(monkeypatch):
    """The decode wrapper's ``plan_slots`` (the verify passes its plain
    tick's slot count): on the CPU the plain version runs unchanged; the
    CUDA branch, run against a stand-in library that records its
    arguments, launches 64 pseudo-slots with the 16-slot tick's run length
    and split count; a bad value raises."""
    import contextlib

    from repro_torch.kernels import (paged_attention_decode,
                                     paged_attention_decode_plain)
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(3)
    k, v = (torch.from_numpy(rng.standard_normal((12, 4, 2, 32))
                             .astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((3, 4, 32)).astype(np.float32))
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 0], [8, 0, 0, 0]],
                         dtype=torch.int32)
    lengths = torch.tensor([15, 9, 2], dtype=torch.int32)
    assert torch.equal(
        paged_attention_decode(q, k, v, table, lengths, plan_slots=1),
        paged_attention_decode_plain(q, k, v, table, lengths))
    for bad in (0, 2.0):
        with pytest.raises(ValueError, match="plan_slots"):
            paged_attention_decode(q, k, v, table, lengths, plan_slots=bad)

    calls = []
    lib = SimpleNamespace(
        repro_paged_attention_decode=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(pa, "_same_device", lambda *ts: torch.device("cuda", 0))
    monkeypatch.setattr(pa, "_num_sms", lambda index: 132)
    monkeypatch.setattr(pa._build, "load", lambda name: lib)
    monkeypatch.setattr(pa._build, "launch_counts",
                        dict(pa._build.launch_counts))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=0))
    pool = torch.zeros((1025, 16, 4, 128))
    qx = torch.zeros((64, 28, 128))
    table_x = torch.zeros((64, 34), dtype=torch.int32)
    len_x = torch.zeros((64,), dtype=torch.int32)
    for slots in (None, 16):
        paged_attention_decode(qx, pool, pool, table_x, len_x,
                               plan_slots=slots)
    own, fixed = pa.decode_split_plan(64, 34, 132), pa.decode_split_plan(
        16, 34, 132)
    assert own != fixed, "the verify's shape needs a plan of its own"
    # argument 18 of the C entry point: blocks per split
    assert [c[18] for c in calls] == [own[0], fixed[0]]
