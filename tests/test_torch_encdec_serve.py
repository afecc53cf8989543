"""Serving the encoder-decoder arch (transformer-big, reduced) on the port,
held against the JAX reference on the CPU, on the reference's weights
carried across by the bridge and inputs made with numpy.

* ``Engine.generate`` over encoder ``frames`` (the reduced config) and over
  ``src_tokens`` (``num_audio_frames=0``, the full config's source mode):
  tokens equal the reference's ``Engine.generate``.
* ``python -m repro_torch.launch.serve --single --arch transformer-big``
  generates 6 tokens, equal to the reference's ``Engine.generate`` on the
  CLI's seeded weights and frames.
* What stays refused: the fleet CLI on transformer-big (exit 2), a ragged
  enc-dec batch; a patches input is ignored, as the reference ignores it.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.serve import Engine as JaxEngine
from repro_torch.checkpoint import params_from_jax, params_to_numpy
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.serve import Engine

ARCH = "transformer-big"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file, the caller's count restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("source", ["frames", "src_tokens"])
def test_generate_matches_reference(source):
    over = {} if source == "frames" else {"num_audio_frames": 0}
    jm = jax_build_model(replace(jax_get_reduced(ARCH), **over))
    pm = build_model(replace(get_reduced(ARCH), **over))
    jp = jax.jit(jm.init)(jax.random.key(1))
    pp = params_from_jax(_np(jp), device="cpu")
    cfg = pm.cfg
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.padded_vocab, (2, 8),
                                    dtype=np.int32)}
    if source == "frames":
        batch["frames"] = (0.1 * rng.standard_normal(
            (2, cfg.num_audio_frames, cfg.d_model))).astype(np.float32)
    else:
        batch["src_tokens"] = rng.integers(0, cfg.padded_vocab, (2, 10),
                                           dtype=np.int32)
    ref = JaxEngine(jm, jp).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, 5)
    got = Engine(pm, pp, device="cpu").generate(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 5)
    assert got.prompt_len == ref.prompt_len == 8
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))


def test_single_cli_generates_the_reference_tokens(capsys):
    """The CLI's seeded weights and frames (its own generator, replayed
    here) through the reference's engine give the CLI's first sequence."""
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--single", "--arch", ARCH, "--max-new", "3",
          "--batch", "2"])
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out
    first = [int(t) for t in out.split("first sequence:")[1].strip()
             .strip("[]").split(",")]
    cfg = get_reduced(ARCH)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg).init(gen, device="cpu",
                                   weight_dtype=cfg.activation_dtype)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.padded_vocab, (2, 64), generator=gen)
    frames = 0.1 * torch.randn((2, cfg.num_audio_frames, cfg.d_model),
                               generator=gen)
    jm = jax_build_model(jax_get_reduced(ARCH))
    ref = JaxEngine(jm, jax.tree.map(jnp.asarray, params_to_numpy(params)))
    res = ref.generate({"tokens": jnp.asarray(tokens.numpy()),
                        "frames": jnp.asarray(frames.numpy())}, 3)
    assert np.asarray(res.tokens[0, 64:]).tolist() == first


def test_what_stays_refused(capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", "--arch", ARCH])
    assert e.value.code == 2
    assert "decoder LMs" in capsys.readouterr().err
    cfg = get_reduced(ARCH)
    gen = torch.Generator()
    gen.manual_seed(0)
    pm = build_model(cfg)
    eng = Engine(pm, pm.init(gen, device="cpu"), device="cpu")
    toks = torch.zeros((2, 4), dtype=torch.long)
    frames = torch.zeros((2, cfg.num_audio_frames, cfg.d_model))
    with pytest.raises(ValueError, match="token-only"):
        eng.generate({"tokens": toks, "frames": frames}, 2,
                     prompt_lens=[4, 2])
    # a patches input is ignored by a config without num_patches, as the
    # reference's enc-dec model ignores it
    with_patches = eng.generate({"tokens": toks, "frames": frames,
                                 "patches": torch.ones((2, 4, cfg.d_model))},
                                2)
    assert torch.equal(with_patches.tokens,
                       eng.generate({"tokens": toks, "frames": frames},
                                    2).tokens)
