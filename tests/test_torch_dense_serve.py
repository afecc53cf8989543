"""Dense serving (``Engine.generate``, ``LM.decode``) held against the JAX
reference on the CPU, on the reference's weights carried across by the
bridge and prompts made with numpy. The cases of
``tests/test_serve_consistency.py`` that apply to the dense family:

* ``LM.decode`` after a split prefill equals the reference's ``LM.decode``
  step by step within 2e-4 (qwen2-7b: GQA, G = 2; qwen1.5-0.5b: MHA, tied
  embeddings), and the port's own teacher forcing within 5e-4;
* the ring buffer (window 6, 16 tokens, a prefill of 8, so the buffer
  wraps): logits equal the reference's decode and the port's windowed
  teacher forcing within 5e-4;
* ``Engine.generate`` at temperature 0 gives the reference's tokens,
  uniform and ragged (lens [12, 5, 9, 7]); ragged equals per-request;
* a bf16 cache stays within 2e-2 of the fp32 cache's logit scale; int8 and
  fp8 are refused by the dense engine; the dtype spellings resolve;
* generation is deterministic, and at temperature 1.0 seeds 0 and 1 give
  different tokens (the two frameworks' random streams differ, so sampled
  tokens are not compared with the reference's);
* ``--single --device cpu`` prints the reference's three lines.
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
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.serve import Engine, GenerationResult, resolve_cache_dtype

torch.set_num_threads(2)


def _pair(arch, **overrides):
    """(jax model, jax params, port model, port params) on shared weights."""
    jm = jax_build_model(replace(jax_get_reduced(arch), **overrides))
    jp = jm.init(jax.random.key(0))
    pm = build_model(replace(get_reduced(arch), **overrides))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, pm, pp


def _tokens(vocab, b, s, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _decode_both(jm, jp, pm, pp, toks, split, cap):
    """Logits of the split prefill and of each decode step after it, from
    the reference and the port: two lists of (B, V) numpy arrays."""
    ref, mine = [], []
    lg, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :split])}, cap=cap,
                        cache_dtype=jnp.float32)
    ref.append(np.asarray(lg[:, 0]))
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        pl, pc = pm.prefill(pp, tt[:, :split], cap, torch.float32)
        mine.append(pl[:, 0].numpy())
        for i in range(split, toks.shape[1]):
            lg, jc = jm.decode(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                               jnp.int32(i))
            ref.append(np.asarray(lg[:, 0]))
            pl, pc = pm.decode(pp, pc, tt[:, i:i + 1], i)
            mine.append(pl[:, 0].numpy())
    return ref, mine


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen1.5-0.5b"])
def test_decode_matches_reference_and_teacher_forcing(arch):
    jm, jp, pm, pp = _pair(arch)
    toks = _tokens(pm.cfg.padded_vocab, 2, 12)
    split = 8
    ref, mine = _decode_both(jm, jp, pm, pp, toks, split, cap=14)
    with torch.no_grad():
        full, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    for step, (r, m) in enumerate(zip(ref, mine)):
        np.testing.assert_allclose(m, r, rtol=0, atol=2e-4,
                                   err_msg=f"{arch} step {step}")
        np.testing.assert_allclose(m, full[:, split - 1 + step].numpy(),
                                   rtol=5e-4, atol=5e-4,
                                   err_msg=f"{arch} teacher forcing {step}")


def test_ring_buffer_decode_matches_reference_and_windowed_forward():
    jm, jp, pm, pp = _pair("qwen2-7b", sliding_window=6)
    toks = _tokens(pm.cfg.padded_vocab, 1, 16)
    split = 8
    ref, mine = _decode_both(jm, jp, pm, pp, toks, split, cap=16)
    cache = pm.init_cache(1, 16, torch.float32, "cpu")
    assert cache["sub0"]["k"].shape[2] == 6, "a ring of the window's length"
    with torch.no_grad():
        full, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    for step, (r, m) in enumerate(zip(ref, mine)):
        np.testing.assert_allclose(m, r, rtol=5e-4, atol=5e-4,
                                   err_msg=f"window step {step}")
        np.testing.assert_allclose(m, full[:, split - 1 + step].numpy(),
                                   rtol=5e-4, atol=5e-4,
                                   err_msg=f"window teacher forcing {step}")


@pytest.fixture(scope="module")
def engines():
    jm, jp, pm, pp = _pair("qwen2-7b")
    return JaxEngine(jm, jp), Engine(pm, pp, device="cpu"), pm.cfg


def test_generate_uniform_matches_reference(engines):
    jeng, eng, cfg = engines
    toks = _tokens(cfg.padded_vocab, 2, 8, seed=3)
    ref = jeng.generate({"tokens": jnp.asarray(toks)}, max_new_tokens=6)
    got = eng.generate({"tokens": torch.from_numpy(toks).long()}, 6)
    assert isinstance(got, GenerationResult) and got.prompt_len == 8
    assert tuple(got.tokens.shape) == (2, 14)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))


def test_generate_ragged_matches_reference_and_per_request(engines):
    jeng, eng, cfg = engines
    lens, new = [12, 5, 9, 7], 6
    toks = _tokens(cfg.padded_vocab, 4, 12, seed=5)
    ref = jeng.generate({"tokens": jnp.asarray(toks)}, new, prompt_lens=lens)
    tt = torch.from_numpy(toks).long()
    got = eng.generate({"tokens": tt}, new, prompt_lens=lens)
    assert got.prompt_lens == lens and got.prompt_len == 12
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    for r, n in enumerate(lens):
        one = eng.generate({"tokens": tt[r:r + 1, :n]}, new)
        np.testing.assert_array_equal(got.tokens[r, 12:].numpy(),
                                      one.tokens[0, n:].numpy(),
                                      err_msg=f"row {r} (len {n})")


def test_generate_refuses_what_the_reference_asserts(engines):
    jeng, eng, cfg = engines
    toks = _tokens(cfg.padded_vocab, 2, 8)
    tt = torch.from_numpy(toks).long()
    with pytest.raises(ValueError, match="prompt_lens"):
        eng.generate({"tokens": tt}, 2, prompt_lens=[9, 3])
    # a config without num_patches ignores a patches input, as the
    # reference's does: the tokens equal the reference's on that batch
    patches = np.random.default_rng(4).standard_normal(
        (2, 4, cfg.d_model)).astype(np.float32)
    ref = jeng.generate({"tokens": jnp.asarray(toks),
                         "patches": jnp.asarray(patches)}, 3)
    got = eng.generate({"tokens": tt, "patches": torch.from_numpy(patches)},
                       3)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    _jm, _jp, wm, wp = _pair("qwen2-7b", sliding_window=6)
    with pytest.raises(ValueError, match="full-length cache"):
        Engine(wm, wp, device="cpu").generate({"tokens": tt}, 2,
                                              prompt_lens=[8, 3])


def test_cache_dtype_parity_and_refusals():
    assert resolve_cache_dtype("auto", "cpu") == torch.float32
    assert resolve_cache_dtype("bf16", "cpu") == torch.bfloat16
    assert resolve_cache_dtype("fp8", "cpu") == torch.float8_e4m3fn
    with pytest.raises(ValueError, match="valid names: auto.*int8"):
        resolve_cache_dtype("int4")
    pm = build_model(get_reduced("qwen2-7b"))
    for dt in (torch.int8, torch.float8_e4m3fn):
        with pytest.raises(ValueError, match="fleet"):
            Engine(pm, params=None, cache_dtype=dt, device="cpu")
    _jm, _jp, pm, pp = _pair("qwen2-7b")
    toks = torch.from_numpy(_tokens(pm.cfg.padded_vocab, 2, 10)).long()
    outs = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            _lg, cache = pm.prefill(pp, toks, 12, dt)
            assert cache["sub0"]["k"].dtype == dt
            lg, _ = pm.decode(pp, cache, toks[:, -1:] * 0 + 1, 10)
            outs[dt] = lg[:, 0].float().numpy()
    scale = np.abs(outs[torch.float32]).max()
    np.testing.assert_allclose(outs[torch.bfloat16], outs[torch.float32],
                               rtol=0, atol=2e-2 * scale)


def test_generation_deterministic_and_seeded():
    pm = build_model(get_reduced("qwen1.5-0.5b"))
    gen = torch.Generator()
    gen.manual_seed(0)
    eng = Engine(pm, pm.init(gen, device="cpu"), device="cpu")
    toks = torch.from_numpy(_tokens(pm.cfg.padded_vocab, 4, 8)).long()
    r1 = eng.generate({"tokens": toks}, 5)
    r2 = eng.generate({"tokens": toks}, 5)
    assert tuple(r1.tokens.shape) == (4, 13)
    assert torch.equal(r1.tokens, r2.tokens)
    s0 = eng.generate({"tokens": toks}, 8, temperature=1.0, seed=0)
    s0b = eng.generate({"tokens": toks}, 8, temperature=1.0, seed=0)
    s1 = eng.generate({"tokens": toks}, 8, temperature=1.0, seed=1)
    assert torch.equal(s0.tokens, s0b.tokens)
    assert not torch.equal(s0.tokens, s1.tokens)


def test_cli_single_prints_the_reference_lines(capsys):
    from repro_torch.launch.serve import main
    main(["--single", "--device", "cpu", "--arch", "qwen2-7b", "--batch", "2",
          "--prompt-len", "8", "--max-new", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "arch=qwen2-7b batch=2 prompt=8 new=3"
    assert lines[1].startswith("generated 6 tokens in ")
    assert "tok/s" in lines[1] and lines[1].endswith("ms/step)")
    assert lines[2].startswith("first sequence: [")
    assert len(eval(lines[2].split(": ", 1)[1])) == 3
    for argv in (["--cache-dtype", "int8"], ["--trace", "t.json"]):
        with pytest.raises(SystemExit) as e:
            main(["--single", "--device", "cpu", *argv])
        assert e.value.code == 2, argv
