"""The port's dense LM held against the JAX reference, on shared weights.

* the weight bridge round-trips a reference ``LM.init`` tree bit for bit;
* the port's init draws the reference's tree shapes and distributions;
* ``LM.prefill`` last-token logits and caches match the reference within
  1e-4 (fp32) for reduced qwen2-7b (GQA, G = 2) and qwen1.5-0.5b (MHA, tied
  embeddings);
* one ``build_decode_step`` tick over the paged pool — fused kernel path and
  gather oracle path — matches the reference's ``LM.decode`` with per-row
  vector positions within 1e-4, with an inactive slot riding along.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import params_from_jax, params_to_numpy, serving_params
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.serve.fleet import PagedCachePool
from repro_torch.serve.fleet.model_exec import build_decode_step

torch.set_num_threads(2)

ARCHS = ["qwen2-7b", "qwen1.5-0.5b"]
TOL = dict(rtol=0, atol=1e-4)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax model, jax params, port model, port params) on shared weights."""
    arch = request.param
    jm = jax_build_model(jax_get_reduced(arch))
    jp = jm.init(jax.random.key(0))
    pm = build_model(get_reduced(arch))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return arch, jm, jp, pm, pp


def test_config_mirrors_reference():
    for arch in ARCHS:
        a, b = jax_get_reduced(arch), get_reduced(arch)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "padded_vocab", "resolved_head_dim", "rope_theta",
                  "tie_embeddings", "qkv_bias", "norm_eps"):
            assert getattr(a, f) == getattr(b, f), (arch, f)
        assert b.activation_dtype == torch.float32


def test_bridge_round_trips_bitwise(pair):
    _arch, _jm, jp, _pm, pp = pair
    ref = _flat(jax.tree.map(np.asarray, jp))
    back = _flat(params_to_numpy(pp))
    assert ref.keys() == back.keys()
    for k in ref:
        assert ref[k].dtype == back[k].dtype and ref[k].shape == back[k].shape, k
        assert np.array_equal(ref[k].view(np.uint8), back[k].view(np.uint8)), k


def test_init_shapes_and_distributions(pair):
    _arch, jm, _jp, pm, _pp = pair
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = _flat(pm.init(gen, device="cpu"))
    shapes = _flat(jax.eval_shape(jm.init, jax.random.key(0)))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}
    d = pm.cfg.d_model
    wq = mine[("layers", "sub0", "mix", "wq")]
    std = 1.0 / d ** 0.5                  # truncated at +-2 std
    assert float(wq.abs().max()) <= 2 * std + 1e-7
    # std of a normal truncated at +-2 sigma is 0.8796 sigma
    assert abs(float(wq.std()) / (0.8796 * std) - 1) < 0.05
    emb = mine[("embed", "tokens")]
    assert abs(float(emb.std()) / 0.02 - 1) < 0.05
    assert bool((mine[("layers", "sub0", "norm1", "scale")] == 1).all())
    assert not mine[("layers", "sub0", "mix", "bq")].any()
    cast = _flat(serving_params(pm.init(gen, device="cpu"), torch.bfloat16))
    for k, v in cast.items():
        want = torch.float32 if "norm" in k[-2] else torch.bfloat16
        assert v.dtype == want, k


def test_prefill_matches_reference(pair):
    arch, jm, jp, pm, pp = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, pm.cfg.padded_vocab, size=(2, 11)).astype(np.int32)
    cap = 14
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cap,
                        cache_dtype=jnp.float32)
    tl, tc = pm.prefill(pp, torch.from_numpy(toks).long(), cap,
                        cache_dtype=torch.float32)
    assert tuple(tl.shape) == (2, 1, pm.cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["sub0"][name].numpy(),
                                   np.asarray(jc["sub0"][name]), **TOL,
                                   err_msg=f"{arch} cache {name}")


@pytest.mark.parametrize("fused", [True, False])
def test_decode_tick_matches_reference_decode(pair, fused):
    """Three live slots at ragged positions plus one inactive slot: the
    paged decode tick's logits equal the reference's dense ``LM.decode``
    with vector positions."""
    arch, jm, jp, pm, pp = pair
    rng = np.random.default_rng(2)
    lens = [5, 9, 3]
    prompts = [rng.integers(0, pm.cfg.padded_vocab, size=n).astype(np.int32)
               for n in lens]
    cap = 16
    caches, firsts = [], []
    for p in prompts:
        lg, c = jm.prefill(jp, {"tokens": jnp.asarray(p)[None]}, cap,
                           cache_dtype=jnp.float32)
        caches.append(c)
        firsts.append(int(jnp.argmax(lg[0, -1])))
    cache = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1), *caches)
    want, _ = jm.decode(jp, cache, jnp.asarray(firsts, jnp.int32)[:, None],
                        jnp.asarray(lens, jnp.int32))

    pool = PagedCachePool(pm, max_slots=4, block_size=4, num_blocks=24,
                          max_blocks_per_slot=4, device="cpu")
    for s, p in enumerate(prompts):
        pool.allocate(s, len(p) + 4)
        lg, c = pm.prefill(pp, torch.from_numpy(p).long()[None], len(p))
        assert int(lg[0, -1].argmax()) == firsts[s]
        pool.insert_prefill(s, c, len(p))
    active = np.array([True, True, True, False])
    tokens = np.array(firsts + [0], np.int64)[:, None]
    wslot, woff = pool.write_maps(active)
    step = build_decode_step(pm, fused_attention=fused)
    got = step(pp, pool.kv, torch.from_numpy(pool.table),
               torch.from_numpy(pool.lengths), torch.from_numpy(wslot),
               torch.from_numpy(woff), torch.from_numpy(tokens))
    np.testing.assert_allclose(got[:3].numpy(), np.asarray(want)[:, 0], **TOL)
    assert bool(torch.isfinite(got[3]).all()), "inactive slot must stay finite"
    assert not pool.kv["sub0"]["k"][:, 0].any(), "null block written"
