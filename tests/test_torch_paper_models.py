"""The paper's own models on the port held against the JAX reference, on the
CPU, on shared weights (``checkpoint/bridge.py``) and shared inputs (numpy
from a seed, or the reference's own batches, handed to both sides).

* Forward logits within 1e-4 of max|ref|: ``ConvNet`` (resnet50-reduced and
  wrn28x10-reduced, with and without ``split``, at image sizes 32 and 33:
  XLA's "SAME" padding at stride 2 pads 0 before and 1 after an even
  input, 1 and 1 an odd one), the ``MLP``, ``EncDecLM`` reading frames and
  reading source tokens; ``layer_norm``, the gelu FFN (and the reference's
  relu -> gelu mapping) and cross-attention with biases as functions.
* ``EncDecLM`` prefill and 4 decode steps within 2e-4, in both source
  modes, the token-source one at a source length equal to the cache's
  capacity; ``init_cache`` mirrors the reference's cross-cache length.
* Three steps of ``train_codist`` on the reference's batches (``fused_losses``
  on: the reference's Pallas kernels in interpret mode, the port's plain
  versions): ConvNet with ``freeze_mask(("stem", "s0"))`` as ``trainable``
  (the frozen leaves bit-unchanged on the port), the MLP with 3 peers and
  kl on the multi-view task, ``EncDecLM`` in both source modes, and the MLP
  under the pipelined and checkpoint exchanges: History losses and
  ``comm_bytes`` within 1e-5 relative.
* A ``checkpoint/io.py`` round trip of a ConvNet tree, both directions.
* The archs resolve and ``build_model`` returns the reference's class;
  reduced qwen1.5-4b and deepseek-67b (ROADMAP 11b) forward as the
  reference's; the training and serving CLIs refuse the conv and enc-dec
  archs with exit 2.
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
from repro.configs import get_reduced as jax_get_reduced
from repro.data.multiview import MultiViewTask as JMultiViewTask
from repro.data.multiview import multiview_batch as jax_multiview_batch
from repro.data.synthetic import classification_batch as jax_class_batch
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models.conv import freeze_mask as jax_freeze_mask
from repro.models.mlp import MLP as JMLP
from repro.models.mlp import MLPConfig as JMLPConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train import train_codist as jax_train_codist
from repro.train.state import init_codist_state as jax_init_codist_state
from repro_torch.checkpoint import (load_pytree, opt_state_from_jax,
                                    params_from_jax, params_to_numpy,
                                    peer_params_from_jax, save_pytree)
from repro_torch.configs import CodistConfig, TrainConfig, get_config, get_reduced
from repro_torch.data import MultiViewTask, classification_batch, multiview_batch
from repro_torch.models import attention as pattn
from repro_torch.models import build_model
from repro_torch.models.common import apply_norm, init_layer_norm, layer_norm
from repro_torch.models.conv import freeze_mask
from repro_torch.models.ffn import ffn_forward
from repro_torch.models.mlp import MLP, MLPConfig
from repro_torch.train import train_codist
from repro_torch.train.state import CodistState, trainable_params

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(arch, **overrides):
    jc, pc = jax_get_reduced(arch), get_reduced(arch)
    if overrides:
        jc, pc = replace(jc, **overrides), replace(pc, **overrides)
    jm, pm = jax_build_model(jc), build_model(pc)
    jp = jm.init(jax.random.key(0))
    return jm, pm, jp, params_from_jax(_np(jp), device="cpu")


def _close(got, want, tol):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (err, tol)


def _close_rel(got, want, tol=1e-5):
    g, w = float(got), float(want)
    assert abs(g - w) <= tol * max(1.0, abs(w)), (g, w)


def _encdec_batch(cfg, b, s, src, rng):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.num_audio_frames > 0:
        batch["frames"] = (0.5 * rng.standard_normal(
            (b, cfg.num_audio_frames, cfg.d_model))).astype(np.float32)
    else:
        batch["src_tokens"] = rng.integers(0, cfg.vocab_size,
                                           (b, src)).astype(np.int32)
    return batch


# ----------------------------------------------------------------------------
# forwards
# ----------------------------------------------------------------------------

def _conv_case(arch, size, split):
    jm, pm, jp, pp = _pair(arch)
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    want, _ = jm.forward(jp, {"images": jnp.asarray(x)}, split=split)
    got, aux = pm.forward(pp, {"images": _t(x)}, split=split)
    assert float(aux) == 0.0 and got.dtype == torch.float32
    return got.detach().numpy(), np.asarray(want)


def _mlp_case():
    jm = JMLP(JMLPConfig(in_dim=64, hidden=(32, 32), num_classes=10))
    pm = MLP(MLPConfig(in_dim=64, hidden=(32, 32), num_classes=10))
    jp = jm.init(jax.random.key(1))
    x = np.random.default_rng(2).standard_normal((5, 64)).astype(np.float32)
    want, _ = jm.forward(jp, {"features": jnp.asarray(x)})
    got, _ = pm.forward(params_from_jax(_np(jp), device="cpu"),
                        {"features": _t(x)})
    return got.detach().numpy(), np.asarray(want)


def _encdec_case(frames):
    kw = {} if frames else {"num_audio_frames": 0}
    jm, pm, jp, pp = _pair("transformer-big", **kw)
    batch = _encdec_batch(pm.cfg, 2, 9, 7, np.random.default_rng(3))
    want, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = pm.forward(pp, {k: _t(v) for k, v in batch.items()})
    assert tuple(got.shape) == (2, 9, pm.cfg.padded_vocab)
    return got.detach().numpy(), np.asarray(want)


def _layer_norm_case():
    rng = np.random.default_rng(4)
    x = (3.0 + rng.standard_normal((3, 5, 48))).astype(np.float32)
    w, b = (rng.standard_normal((2, 48)) * 0.5 + [[1.0], [0.0]]).astype(
        np.float32)
    want = jcommon.apply_norm({"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                              jnp.asarray(x))
    got = apply_norm({"scale": _t(w), "bias": _t(b)}, _t(x))
    assert torch.equal(got, layer_norm(_t(x), _t(w), _t(b)))
    init = init_layer_norm(48, device="cpu")
    for k, v in jcommon.init_layer_norm(48).items():
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(v))
    return got.numpy(), np.asarray(want)


def _ffn_case(act):
    cfg = replace(jax_get_reduced("transformer-big"), act=act)
    jp = jffn.init_ffn(jax.random.key(5), cfg)
    assert sorted(jp) == ["w_down", "w_up"]
    x = np.random.default_rng(5).standard_normal((2, 3, cfg.d_model)).astype(
        np.float32)
    want = jffn.ffn_forward(jp, jnp.asarray(x), cfg)
    pcfg = replace(get_reduced("transformer-big"), act=act)
    got = ffn_forward(params_from_jax(_np(jp), device="cpu"), _t(x), pcfg)
    return got.numpy(), np.asarray(want)


def _cross_case():
    cfg = replace(jax_get_reduced("transformer-big"), qkv_bias=True)
    pcfg = replace(get_reduced("transformer-big"), qkv_bias=True)
    rng = np.random.default_rng(6)
    jp = _np(jattn.init_attention(jax.random.key(6), cfg))
    for name in ("bq", "bk", "bv"):        # non-zero biases
        jp[name] = (0.1 * rng.standard_normal(jp[name].shape)).astype(
            np.float32)
    pp = params_from_jax(jp, device="cpu")
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    jx, jmem = jnp.asarray(x), jnp.asarray(mem)
    want = jattn.cross_attention_forward(jp, jx, jmem, cfg)
    got = pattn.cross_attention_forward(pp, _t(x), _t(mem), pcfg)
    jkv = jattn.encoder_kv(jp, jmem, cfg)
    pkv = pattn.encoder_kv(pp, _t(mem), pcfg)
    for k in ("k", "v"):
        _close(pkv[k].numpy(), jkv[k], 1e-5)
    jd = jattn.cross_attention_decode(jp, jx[:, :1], jkv, cfg)
    pd = pattn.cross_attention_decode(pp, _t(x)[:, :1], pkv, pcfg)
    _close(pd.numpy(), jd, 1e-4)
    return got.numpy(), np.asarray(want)


FORWARD_CASES = {
    **{f"{a}-{s}-{'split' if sp else 'whole'}":
       (lambda a=a, s=s, sp=sp: _conv_case(a, s, sp))
       for a in ("resnet50", "wrn28x10") for s in (32, 33)
       for sp in (None, (1, 2))},
    "mlp": _mlp_case,
    "encdec-frames": lambda: _encdec_case(True),
    "encdec-src-tokens": lambda: _encdec_case(False),
    "layer_norm": _layer_norm_case,
    "ffn-gelu": lambda: _ffn_case("gelu"),
    "ffn-relu-as-gelu": lambda: _ffn_case("relu"),
    "cross-attention": _cross_case,
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_reference(case):
    got, want = FORWARD_CASES[case]()
    assert got.shape == want.shape and np.isfinite(got).all()
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "deepseek-67b"])
def test_dense_archs_forward_as_reference(arch):
    jm, pm, jp, pp = _pair(arch)
    toks = np.random.default_rng(7).integers(
        0, pm.cfg.padded_vocab, (2, 10)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = pm.forward(pp, {"tokens": _t(toks)})
    _close(got.detach().numpy(), want, 1e-4)


@pytest.mark.parametrize("frames", [True, False], ids=["frames", "src-tokens"])
def test_encdec_prefill_and_decode(frames):
    kw = {} if frames else {"num_audio_frames": 0}
    jm, pm, jp, pp = _pair("transformer-big", **kw)
    cap, s, steps = 12, 6, 4
    rng = np.random.default_rng(8)
    batch = _encdec_batch(pm.cfg, 2, s, cap, rng)
    mem_len = pm.cfg.num_audio_frames or cap
    jcache0 = jm.init_cache(2, cap, jnp.float32)
    pcache0 = pm.init_cache(2, cap, torch.float32, device="cpu")
    for kind in ("self", "cross"):
        for k in ("k", "v"):
            assert (tuple(pcache0[kind][k].shape)
                    == jcache0[kind][k].shape)
    assert pcache0["cross"]["k"].shape[2] == mem_len
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                        cap, cache_dtype=jnp.float32)
    pl, pc = pm.prefill(pp, {k: _t(v) for k, v in batch.items()}, cap,
                        cache_dtype=torch.float32)
    _close(pl.numpy(), jl, 2e-4)
    assert tuple(pc["cross"]["k"].shape) == jc["cross"]["k"].shape
    for i in range(steps):
        tok = rng.integers(0, pm.cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.int32(s + i))
        pl, pc = pm.decode(pp, pc, _t(tok), s + i)
        _close(pl.numpy(), jl, 2e-4)
    for kind in ("self", "cross"):
        _close(pc[kind]["k"].numpy(), jc[kind]["k"], 2e-4)


# ----------------------------------------------------------------------------
# three training steps on both sides
# ----------------------------------------------------------------------------

MV_TASK = dict(n_views=8, view_dim=8, latent_dim=24, num_classes=10, seed=0)


def _mv_batches(n, steps, b=16):
    task = JMultiViewTask(**MV_TASK)
    out = []
    for k in range(steps):
        raw = jax_multiview_batch(task, b, k)
        out.append({
            "features": np.stack([np.asarray(raw["features"]
                                             * task.view_mask(i % 8))
                                  for i in range(n)]),
            "labels": np.stack([np.asarray(raw["labels"])] * n)})
    return out


def _conv_batches(cfg, n, steps, b=2):
    out = []
    for k in range(steps):
        raw = jax_class_batch(jax.random.key(10 + k), b, 16, cfg.num_classes,
                              image=True, image_size=cfg.image_size)
        out.append({"images": np.stack([np.asarray(raw["images"])] * n),
                    "labels": np.stack([np.asarray(raw["labels"])] * n)})
    return out


def _encdec_batches(cfg, n, steps, b=2, s=8):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(steps):
        one = _encdec_batch(cfg, b, s, 8, rng)
        one["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
        one["mask"] = (rng.random((b, s)) > 0.2).astype(np.float32)
        out.append({k: np.stack([v] * n) for k, v in one.items()})
    return out


def _models(name):
    if name == "conv":
        return (jax_build_model(jax_get_reduced("wrn28x10")),
                build_model(get_reduced("wrn28x10")))
    if name.startswith("encdec"):
        kw = {} if name == "encdec-frames" else {"num_audio_frames": 0}
        return (jax_build_model(replace(jax_get_reduced("transformer-big"),
                                        **kw)),
                build_model(replace(get_reduced("transformer-big"), **kw)))
    cfg = dict(in_dim=64, hidden=(32, 32), num_classes=10)
    return JMLP(JMLPConfig(**cfg)), MLP(MLPConfig(**cfg))


TRAIN_CASES = {
    "conv-frozen-stage0": ("conv", dict(n_models=2)),
    "mlp-n3-kl": ("mlp", dict(n_models=3, distill_loss="kl", alpha0=2.0)),
    "encdec-frames": ("encdec-frames", dict(n_models=2)),
    "encdec-src-tokens": ("encdec-src", dict(n_models=2)),
    "mlp-pipelined": ("mlp", dict(n_models=2, pipelined=True)),
    "mlp-ckpt": ("mlp", dict(n_models=2, mode="checkpoints", period=2)),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_three_codist_steps_match_reference(case):
    name, ckw = TRAIN_CASES[case]
    steps = 3
    jm, pm = _models(name)
    n = ckw["n_models"]
    if name == "conv":
        batches = _conv_batches(pm.cfg, n, steps)
    elif name.startswith("encdec"):
        batches = _encdec_batches(pm.cfg, n, steps)
    else:
        batches = _mv_batches(n, steps)
    kw = dict(lr=0.05, warmup_steps=0, total_steps=steps, optimizer="sgdm",
              label_smoothing=0.1, fused_losses=True)
    jtc, ptc = JTrainConfig(**kw), TrainConfig(**kw)
    jcd, pcd = JCodistConfig(**ckw), CodistConfig(**ckw)
    j_init, _ = jax_make_optimizer("sgdm")
    jstate = jax_init_codist_state(jm, jax.random.key(0), n, j_init)
    pstate = CodistState(
        trainable_params(peer_params_from_jax(_np(jstate.params), n,
                                              device="cpu")),
        opt_state_from_jax(jstate.opt, n, device="cpu"), 0)
    jtrain = ptrain = None
    if name == "conv":
        jtrain = jax_freeze_mask(jax.tree.map(lambda x: x[0], jstate.params),
                                 ("stem", "s0"))
        ptrain = freeze_mask(pstate.params[0], ("stem", "s0"))
        assert jax.tree.leaves(jtrain) == [
            v for v in jax.tree.leaves(ptrain)]
        before = [{k: v.detach().clone() for k, v in _frozen(p).items()}
                  for p in pstate.params]
        live = pstate.params[0]["s1b0"]["conv1"].detach().clone()
    _js, jh = jax_train_codist(
        jm, jcd, jtc, lambda k: {a: jnp.asarray(v)
                                 for a, v in batches[k].items()},
        log_every=1, state=jstate, trainable=jtrain)
    pst, ph = train_codist(
        pm, pcd, ptc, lambda k: {a: _t(v) for a, v in batches[k].items()},
        log_every=1, state=pstate, trainable=ptrain, device="cpu")
    assert len(ph.records) == len(jh.records) == steps
    for jr, pr in zip(jh.records, ph.records):
        for key in ("loss", "task_loss", "distill_loss", "comm_bytes",
                    "comm_events"):
            _close_rel(pr[key], jr[key])
    assert ph.records[-1]["comm_bytes"] > 0
    if name == "conv":
        for p, b in zip(pst.params, before):
            for k, v in _frozen(p).items():
                assert torch.equal(v, b[k]), k
        assert not torch.equal(pst.params[0]["s1b0"]["conv1"], live)


def _frozen(params):
    out = {"stem": params["stem"]}
    out.update({f"s0b0/{k}": v for k, v in params["s0b0"].items()})
    return out


# ----------------------------------------------------------------------------
# checkpoints, configs, data, CLIs
# ----------------------------------------------------------------------------

def test_conv_checkpoint_round_trips_with_the_reference(tmp_path):
    jm, pm, jp, pp = _pair("resnet50")
    save_pytree(str(tmp_path / "port"), params_to_numpy(pp))
    loaded = jax_load_pytree(str(tmp_path / "port"), jp)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(loaded)[0],
                            jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
    jax_save_pytree(str(tmp_path / "ref"), jp)
    back = load_pytree(str(tmp_path / "ref"), params_to_numpy(pp))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, want in flat:
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_archs_resolve_and_build_as_the_reference():
    for arch, cls in (("resnet50", "ConvNet"), ("wrn28x10", "ConvNet"),
                      ("transformer-big", "EncDecLM"), ("qwen1.5-4b", "LM"),
                      ("deepseek-67b", "LM")):
        for get in (get_config, get_reduced):
            assert type(build_model(get(arch))).__name__ == cls, arch
        jr, pr = jax_get_reduced(arch), get_reduced(arch)
        for f in ("num_classes", "depths", "widths", "num_layers", "d_model",
                  "num_heads", "num_kv_heads", "d_ff", "vocab_size",
                  "encoder_layers", "num_audio_frames", "act"):
            assert getattr(pr, f, None) == getattr(jr, f, None), (arch, f)
    assert get_reduced("transformer-big").num_audio_frames == 64
    assert get_config("transformer-big").num_audio_frames == 0


def test_data_shapes_and_determinism():
    gen = torch.Generator()
    gen.manual_seed(0)
    b = classification_batch(gen, 4, 16, 10, image=True, image_size=8)
    assert tuple(b["images"].shape) == (4, 8, 8, 3)
    assert b["labels"].dtype == torch.int32
    assert bool(((b["labels"] >= 0) & (b["labels"] < 10)).all())
    task = MultiViewTask(**MV_TASK)
    one = multiview_batch(task, 6, 3, device="cpu")
    assert tuple(one["features"].shape) == (6, task.dim)
    assert torch.equal(one["features"],
                       multiview_batch(task, 6, 3, device="cpu")["features"])
    m = task.view_mask(2, device="cpu")
    assert float(m.sum()) == task.view_dim and float(m[16]) == 1.0


@pytest.mark.parametrize("cli,arch", [("train", "resnet50"),
                                      ("train", "transformer-big"),
                                      ("serve", "wrn28x10")])
def test_clis_refuse_the_paper_models(cli, arch, capsys):
    if cli == "train":
        from repro_torch.launch.train import main
    else:
        from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "--arch", arch])
    assert e.value.code == 2
    assert "decoder LMs" in capsys.readouterr().err
