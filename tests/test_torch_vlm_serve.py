"""The VLM patch prefix (internvl2-76b) and whisper-tiny on the port, held
against the JAX reference on the CPU, on the reference's weights carried
across by the bridge and inputs made with numpy.

* The reduced internvl2 forward over ``patches`` (logits over the text
  tokens only) and the reduced whisper-tiny forward over ``frames`` within
  1e-4 of max|ref|; the bridge carries both trees leaf for leaf and back.
* ``Engine.generate`` over a ``patches`` batch (internvl2) and a ``frames``
  batch (whisper-tiny): tokens equal the reference's.
* ``python -m repro_torch.launch.serve --single`` on transformer-big,
  whisper-tiny and internvl2-76b: the CLI's first sequence equals the
  reference's ``Engine.generate`` on the CLI's seeded weights and inputs.
* The fleet CLI exits 2 on whisper-tiny and internvl2-76b, as the
  reference's; the training CLI exits 2 on whisper-tiny (the reference's
  dies there on the missing frames) and trains internvl2 text-only.
* 3 codist steps of the reduced internvl2 over batches with ``patches``
  within 1e-5 relative of the reference's ``PredictionExchange``.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CodistConfig as JCodistConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro.serve import Engine as JaxEngine
from repro.train import PredictionExchange as JPredictionExchange
from repro.train import build_train_step as jax_build_train_step
from repro.train.state import init_codist_state as jax_init_codist_state
from repro_torch.checkpoint import (opt_state_from_jax, params_from_jax,
                                    params_to_numpy, peer_params_from_jax)
from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
from repro_torch.models import build_model
from repro_torch.serve import Engine
from repro_torch.train import PredictionExchange, build_train_step
from repro_torch.train.state import CodistState, trainable_params

VLM, AUDIO = "internvl2-76b", "whisper-tiny"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file, the caller's count restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def pairs():
    """{arch: (reference model, its params, port model, bridged params)},
    each reference init jitted once for the module."""
    out = {}
    for arch in (VLM, AUDIO):
        jm = jax_build_model(jax_get_reduced(arch))
        jp = jax.jit(jm.init)(jax.random.key(1))
        pm = build_model(get_reduced(arch))
        out[arch] = (jm, jp, pm, params_from_jax(_np(jp), device="cpu"))
    return out


def _inputs(cfg, b, s, seed):
    """Token prompts and the arch's stub-frontend input, from numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.padded_vocab, (b, s),
                                    dtype=np.int32)}
    if cfg.num_patches:
        batch["patches"] = (0.1 * rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model))).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = (0.1 * rng.standard_normal(
            (b, cfg.num_audio_frames, cfg.d_model))).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forward_matches_reference(pairs, arch):
    jm, jp, pm, pp = pairs[arch]
    cfg = pm.cfg
    assert (cfg.num_patches == 16 if arch == VLM
            else cfg.num_audio_frames == 64)
    want, got = _flat(_np(jp)), _flat(params_to_numpy(pp))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    batch = _inputs(cfg, 2, 11, seed=0)
    jl, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, _ = pm.forward(pp, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert tuple(tl.shape) == (2, 11, cfg.padded_vocab) == jl.shape
    ref = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    if arch == VLM:
        # the prefix moves the text logits; a config without num_patches
        # ignores the input, as the reference's
        with torch.no_grad():
            text_only, _ = pm.forward(pp, {"tokens": torch.from_numpy(
                batch["tokens"])})
            blind, _ = build_model(replace(cfg, num_patches=0)).forward(
                pp, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert not torch.allclose(text_only, tl)
        assert torch.equal(blind, text_only)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_generate_matches_reference(pairs, arch):
    jm, jp, pm, pp = pairs[arch]
    batch = _inputs(pm.cfg, 2, 8, seed=1)
    ref = JaxEngine(jm, jp).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, 5)
    got = Engine(pm, pp, device="cpu").generate(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 5)
    assert got.prompt_len == ref.prompt_len == 8
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    if arch == VLM:
        # the prefix holds the first num_patches cache positions
        _lg, cache = pm.prefill(pp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, 30)
        assert cache["sub0"]["k"].shape[2] == 30
        assert cache["sub0"]["k"][:, :, 16 + 8:].abs().sum() == 0
        assert cache["sub0"]["k"][:, :, 16 + 7].abs().sum() > 0
        with pytest.raises(ValueError, match="capacity"):
            pm.prefill(pp, {k: torch.from_numpy(v)
                            for k, v in batch.items()}, 20)
        with pytest.raises(ValueError, match="token-only"):
            Engine(pm, pp, device="cpu").generate(
                {k: torch.from_numpy(v) for k, v in batch.items()}, 2,
                prompt_lens=[8, 5])


@pytest.mark.parametrize("arch", ["transformer-big", AUDIO, VLM])
def test_single_cli_generates_the_reference_tokens(capsys, arch):
    """The CLI's seeded weights and inputs (its own generator, replayed
    here) through the reference's engine give the CLI's first sequence."""
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--single", "--arch", arch, "--max-new", "3",
          "--batch", "2", "--prompt-len", "16"])
    out = capsys.readouterr().out
    assert f"arch={arch} batch=2 prompt=16 new=3" in out
    assert "generated 6 tokens" in out
    first = [int(t) for t in out.split("first sequence:")[1].strip()
             .strip("[]").split(",")]
    cfg = get_reduced(arch)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg).init(gen, device="cpu",
                                   weight_dtype=cfg.activation_dtype)
    gen.manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.padded_vocab, (2, 16),
                                     generator=gen)}
    if cfg.num_patches:
        batch["patches"] = 0.1 * torch.randn((2, cfg.num_patches,
                                              cfg.d_model), generator=gen)
    if cfg.is_encdec:
        batch["frames"] = 0.1 * torch.randn(
            (2, cfg.num_audio_frames, cfg.d_model), generator=gen)
    jm = jax_build_model(jax_get_reduced(arch))
    ref = JaxEngine(jm, jax.tree.map(jnp.asarray, params_to_numpy(params)))
    res = ref.generate({k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                       3)
    assert np.asarray(res.tokens[0, 16:]).tolist() == first


@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_fleet_cli_refuses(capsys, arch):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "--arch", arch, "--requests", "2"])
    assert e.value.code == 2
    assert "--single" in capsys.readouterr().err


def test_train_cli_refuses_whisper_and_trains_internvl2(capsys):
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "--arch", AUDIO, "--steps", "1"])
    assert e.value.code == 2
    assert "frames" in capsys.readouterr().err
    main(["--device", "cpu", "--arch", VLM, "--steps", "2", "--batch", "2",
          "--seq", "8", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out and "distill_loss=" in out


def test_three_codist_steps_over_patches_match_reference(pairs):
    """PredictionExchange, 2 peers, mse, SGD momentum, batches with a patch
    prefix: per-step loss, task and distill within 1e-5 relative."""
    jm, _jp, pm, _pp = pairs[VLM]
    cfg, n, b, s, steps = pm.cfg, 2, 2, 8, 3
    kw = dict(lr=0.05, warmup_steps=0, total_steps=steps, optimizer="sgdm",
              label_smoothing=0.1, fused_losses=True)
    jtc, ptc = JTrainConfig(**kw), TrainConfig(**kw)
    jcd, pcd = JCodistConfig(n_models=n), CodistConfig(n_models=n)
    j_init, _ = jax_make_optimizer("sgdm")
    jstate = jax_init_codist_state(jm, jax.random.key(0), n, j_init)
    pstate = CodistState(
        trainable_params(peer_params_from_jax(_np(jstate.params), n,
                                              device="cpu")),
        opt_state_from_jax(jstate.opt, n, device="cpu"), 0)
    jb = jax_build_train_step(jm, jtc, jcd, JPredictionExchange(jcd))
    pb = build_train_step(pm, ptc, pcd, PredictionExchange(pcd))
    rng = np.random.default_rng(3)
    for k in range(steps):
        batch = {
            "tokens": rng.integers(0, cfg.vocab_size, (n, b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (n, b, s)).astype(
                np.int32),
            "mask": (rng.random((n, b, s)) > 0.2).astype(np.float32),
            "patches": (0.1 * rng.standard_normal(
                (n, b, cfg.num_patches, cfg.d_model))).astype(np.float32)}
        jstate, jmet, _ = jb.apply(
            jstate, {a: jnp.asarray(v) for a, v in batch.items()}, k)
        pstate, pmet, _ = pb.apply(
            pstate, {a: torch.from_numpy(v) for a, v in batch.items()}, k)
        for key in ("loss", "task_loss", "distill_loss"):
            g, w = float(pmet[key]), float(jmet[key])
            assert abs(g - w) <= 1e-5 * max(1.0, abs(w)), (k, key, g, w)
        assert float(pmet["distill_loss"]) > 0
