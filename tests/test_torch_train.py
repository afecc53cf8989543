"""The port's training path held against the JAX reference, on shared
weights, optimizer states and batches (numpy, handed to both sides).

* ``LM.forward`` logits of reduced qwen1.5-0.5b (fp32), and of the same
  with ``vocab_size=700`` (padded to 768, so the reference's fused losses
  pad the vocab to their block), within 1e-5.
* One AdamW and one SGD-momentum update on shared gradients within 1e-6.
* Three steps of ``PredictionExchange`` (mse, kl) and of ``AllReduce``
  with ``fused_losses=True``: the reference runs its Pallas kernels in
  interpret mode, the port its kernels' plain versions. Per-step ``loss``,
  ``task_loss`` and ``distill_loss`` within 1e-5 relative; after three
  SGD-momentum steps the parameters within 1e-5. AdamW runs are held to
  their losses only: its first update is sign(g) * lr, so a gradient that
  rounds across zero on one side moves that parameter by 2 * lr.
* ``period=2`` takes the off variant (task CE only) on step 1.
* ``microbatch=2`` equals ``microbatch=1`` within 1e-5 (the port alone).
* The port's ``History.save`` is read by the reference's ``History.load``.
* The CLI trains on the CPU; with ``--trace``, ``--metrics``,
  ``--alerts`` and ``--flight-recorder`` it writes files that
  ``tools/trace_check.py`` passes. As the reference, it exits 2 on
  ``--rules`` or ``--flight-recorder`` without ``--alerts``.
* Entry points default to the card; the checkpoint and pipelined
  strategies resolve, and the shard_map one on a pod group.
"""
import json
import os
import sys
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
from repro.train import AllReduce as JAllReduce
from repro.train import History as JHistory
from repro.train import PredictionExchange as JPredictionExchange
from repro.train import build_train_step as jax_build_train_step
from repro.train.state import init_codist_state as jax_init_codist_state
from repro.train.state import init_train_state as jax_init_train_state
from repro_torch.checkpoint import (opt_state_from_jax, params_from_jax,
                                    peer_params_from_jax, peer_params_to_numpy,
                                    params_to_numpy)
from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train import (AllReduce, History, PredictionExchange,
                               build_train_step)
from repro_torch.train.state import CodistState, TrainState, trainable_params

torch.set_num_threads(2)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

ARCH = "qwen1.5-0.5b"
B, S = 2, 8


def _configs(vocab=None):
    jc, pc = jax_get_reduced(ARCH), get_reduced(ARCH)
    if vocab is not None:
        jc, pc = replace(jc, vocab_size=vocab), replace(pc, vocab_size=vocab)
    return jc, pc


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _close_rel(got, want, tol=1e-5):
    g, w = float(got), float(want)
    assert abs(g - w) <= tol * max(1.0, abs(w)), (g, w)


@pytest.mark.parametrize("vocab", [None, 700])
def test_forward_matches_reference(vocab):
    jc, pc = _configs(vocab)
    jm, pm = jax_build_model(jc), build_model(pc)
    jp = jm.init(jax.random.key(0))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, pc.padded_vocab,
                                             size=(2, 11)).astype(np.int32)
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    assert tuple(tl.shape) == (2, 11, pc.padded_vocab)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)
    assert float(taux) == float(jaux) == 0.0
    rl, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks)}, remat=True)
    assert torch.equal(rl, tl)


@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
def test_optimizer_update_matches_reference(kind):
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal((3,)).astype(np.float32)}}
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape)
                         .astype(np.float32), params)
    j_init, j_upd = jax_make_optimizer(kind, momentum=0.9, b1=0.9, b2=0.95)
    p_init, p_upd = make_optimizer(kind, momentum=0.9, b1=0.9, b2=0.95)
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = j_init(jparams)
    # a non-trivial starting state: one update already taken on both sides
    jparams, jopt = j_upd(jparams, jax.tree.map(jnp.asarray, grads), jopt,
                          0.01, 1e-3)
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    popt = opt_state_from_jax(jopt, device="cpu")
    assert popt.step == 1 and (popt.v is None) == (kind == "sgdm")
    g2 = jax.tree.map(lambda p: (p * 0.5 + 0.1).astype(np.float32), grads)
    jparams, jopt = j_upd(jparams, jax.tree.map(jnp.asarray, g2), jopt, 0.02,
                          1e-3)
    pparams, popt = p_upd(pparams, params_from_jax(g2, device="cpu"), popt,
                          0.02, 1e-3)
    assert popt.step == 2
    want, got = _flat(jparams), _flat(params_to_numpy(pparams))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    for name in ("m", "v") if kind == "adamw" else ("m",):
        w = _flat(getattr(jopt, name))
        g = _flat(params_to_numpy(getattr(popt, name)))
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6)


# ----------------------------------------------------------------------------
# three training steps on both sides
# ----------------------------------------------------------------------------

def _batches(cfg, n, steps, seed=3, full_mask=False):
    rng = np.random.default_rng(seed)
    lead = (n, B, S) if n else (B, S)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, size=lead).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, size=lead).astype(np.int32)
        mask = (np.ones(lead) if full_mask
                else (rng.random(lead) > 0.2)).astype(np.float32)
        out.append({"tokens": toks, "labels": labels, "mask": mask})
    return out


def _run_both(strategy_name, distill, optimizer, steps=3, vocab=None,
              period=1):
    jc, pc = _configs(vocab)
    jm, pm = jax_build_model(jc), build_model(pc)
    lr = 0.05 if optimizer == "sgdm" else 1e-3
    kw = dict(lr=lr, warmup_steps=0, total_steps=steps, optimizer=optimizer,
              label_smoothing=0.1, fused_losses=True)
    jtc, ptc = JTrainConfig(**kw), TrainConfig(**kw)
    j_init, _ = jax_make_optimizer(optimizer)
    if strategy_name == "allreduce":
        jcd = pcd = None
        jst, pst = JAllReduce(), AllReduce()
        jstate = jax_init_train_state(jm, jax.random.key(0), j_init)
        pstate = TrainState(
            trainable_params(params_from_jax(
                jax.tree.map(np.asarray, jstate.params), device="cpu")),
            opt_state_from_jax(jstate.opt, device="cpu"), 0)
        n = 0
    else:
        n = 2
        ckw = dict(n_models=n, distill_loss=distill, period=period)
        jcd, pcd = JCodistConfig(**ckw), CodistConfig(**ckw)
        jst, pst = JPredictionExchange(jcd), PredictionExchange(pcd)
        jstate = jax_init_codist_state(jm, jax.random.key(0), n, j_init)
        pstate = CodistState(
            trainable_params(peer_params_from_jax(
                jax.tree.map(np.asarray, jstate.params), n, device="cpu")),
            opt_state_from_jax(jstate.opt, n, device="cpu"), 0)
    jb = jax_build_train_step(jm, jtc, jcd, jst)
    pb = build_train_step(pm, ptc, pcd, pst)
    rows = []
    for k, batch in enumerate(_batches(pc, n, steps)):
        jstate, jmet, jplan = jb.apply(
            jstate, {a: jnp.asarray(v) for a, v in batch.items()}, k)
        pstate, pmet, pplan = pb.apply(
            pstate, {a: torch.from_numpy(v) for a, v in batch.items()}, k)
        assert (jplan.distill, jplan.exchange) == (pplan.distill, pplan.exchange)
        rows.append((jmet, pmet))
    return jstate, pstate, rows


CASES = [("codist", "mse", "sgdm", None), ("codist", "kl", "sgdm", None),
         ("codist", "kl", "sgdm", 700), ("codist", "mse", "adamw", None),
         ("allreduce", None, "sgdm", None), ("allreduce", None, "adamw", None)]


@pytest.mark.parametrize("strategy,distill,optimizer,vocab", CASES)
def test_three_steps_match_reference(strategy, distill, optimizer, vocab):
    jstate, pstate, rows = _run_both(strategy, distill, optimizer, vocab=vocab)
    keys = ("loss", "task_loss") + (("distill_loss",) if distill else ())
    for jmet, pmet in rows:
        for key in keys:
            _close_rel(pmet[key], jmet[key])
        np.testing.assert_allclose(np.asarray(pmet["task_loss_per_model"])
                                   if distill else 0.0,
                                   np.asarray(jmet["task_loss_per_model"])
                                   if distill else 0.0, rtol=1e-5)
    assert pstate.step == int(jstate.step) == 3
    if optimizer != "sgdm":
        return                    # AdamW: losses only (see module docstring)
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    got = _flat(peer_params_to_numpy(pstate.params) if distill
                else params_to_numpy(pstate.params))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=str(k))


def test_period_two_takes_the_off_variant():
    _j, _p, rows = _run_both("codist", "mse", "sgdm", steps=2, period=2)
    (j0, p0), (j1, p1) = rows
    assert float(p0["distill_loss"]) > 0 and float(p0["alpha"]) == 1.0
    assert float(p1["distill_loss"]) == 0.0 and float(p1["alpha"]) == 0.0
    for jmet, pmet in rows:
        for key in ("loss", "task_loss", "distill_loss"):
            _close_rel(pmet[key], jmet[key])


def test_microbatch_two_equals_one():
    pc = get_reduced(ARCH)
    pm = build_model(pc)
    cd = CodistConfig(n_models=2)
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(pc, 2, 1, full_mask=True)[0].items()}
    split = {k: v.reshape(2, 2, B // 2, S) for k, v in batch.items()}
    results = []
    for k, b in ((0, batch), (2, split)):
        gen = torch.Generator()
        gen.manual_seed(0)
        tc = TrainConfig(lr=0.05, warmup_steps=0, total_steps=1,
                         microbatch=k, fused_losses=True)
        st = PredictionExchange(cd)
        opt_init, _ = make_optimizer(tc.optimizer)
        state = st.init_state(pm, tc, gen, opt_init, device="cpu")
        state, met, _ = build_train_step(pm, tc, cd, st).apply(state, b, 0)
        results.append((peer_params_to_numpy(state.params), met))
    (p1, m1), (p2, m2) = results
    for key in ("loss", "task_loss", "distill_loss"):
        _close_rel(m2[key], m1[key])
    a, b = _flat(p1), _flat(p2)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5)


def test_history_is_read_by_the_reference(tmp_path):
    hist = History()
    hist.log(0, {"loss": torch.tensor(1.5),
                 "task_loss_per_model": torch.tensor([1.0, 2.0])},
             comm_bytes=10.0)
    hist.log(1, {"loss": 1.25}, comm_bytes=20.0)
    path = str(tmp_path / "h.jsonl")
    hist.save(path)
    ref = JHistory.load(path)
    assert ref.records == hist.records
    assert ref.series("loss") == [1.5, 1.25]
    assert ref.records[0]["task_loss_per_model_1"] == 2.0
    assert History.load(path).records == hist.records


def test_cli_trains_on_cpu_and_refuses_unported_flags(capsys, tmp_path):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--mode", "codist", "--steps", "2", "--batch",
          "2", "--seq", "8", "--log-every", "1", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step=1 task_loss=" in out and "done: 2 steps" in out
    assert (tmp_path / "history.json").exists()
    main(["--device", "cpu", "--mode", "allreduce", "--steps", "1", "--batch",
          "2", "--seq", "8"])
    main(["--device", "cpu", "--mode", "codist", "--steps", "1", "--batch",
          "2", "--seq", "8", "--distill-loss", "ce", "--fused-losses", "on",
          "--compression", "bf16"])
    out = capsys.readouterr().out
    assert out.count("done: 1 steps") == 2
    # the obs flags on the step clock: trace, metrics and alert log valid
    obs = {k: str(tmp_path / f"o.{k}") for k in ("trace", "metrics",
                                                 "alerts")}
    main(["--device", "cpu", "--mode", "codist", "--steps", "2", "--batch",
          "2", "--seq", "8", "--log-every", "1", "--trace", obs["trace"],
          "--metrics", obs["metrics"], "--alerts", obs["alerts"],
          "--flight-recorder", str(tmp_path / "pm")])
    out = capsys.readouterr().out
    assert f"wrote {obs['trace']}" in out and "done: 2 steps" in out
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import trace_check
    assert trace_check.main(list(obs.values())) == 0
    with open(obs["metrics"]) as f:
        assert json.load(f)["counters"]["train/comm_events"] == 2
    for argv in (["--rules", "r.json"], ["--flight-recorder", "d"]):
        with pytest.raises(SystemExit) as e:
            main(["--device", "cpu", *argv])
        assert e.value.code == 2, argv


def test_cuda_default_and_later_strategies_raise():
    """Entry points default to the card and raise without one; the
    checkpoint, pipelined and shard_map strategies resolve, the last only
    on a pod group (``launch/mesh.py``): without one it raises."""
    from repro_torch.data import MarkovLM, make_lm_batch
    from repro_torch.train import (CheckpointExchange, PipelinedPredictions,
                                   ShardMapCompressed, resolve_strategy,
                                   train_codist)
    assert isinstance(resolve_strategy(None), AllReduce)
    assert isinstance(resolve_strategy(CodistConfig()), PredictionExchange)
    assert isinstance(resolve_strategy(CodistConfig(mode="checkpoints")),
                      CheckpointExchange)
    assert isinstance(resolve_strategy(CodistConfig(pipelined=True)),
                      PipelinedPredictions)
    from repro_torch.launch.mesh import PodGroup
    assert isinstance(resolve_strategy(CodistConfig(),
                                       mesh=PodGroup(0, 2, torch.device("cpu"))),
                      ShardMapCompressed)
    with pytest.raises(ValueError, match="pod group"):
        resolve_strategy(CodistConfig(), mesh=object())
    with pytest.raises(ValueError, match="pod group"):
        ShardMapCompressed(CodistConfig())
    if torch.cuda.is_available():
        return
    task = MarkovLM(vocab=64)
    with pytest.raises(RuntimeError, match="cuda"):
        make_lm_batch(task, 1, 4, 0)
    pm = build_model(get_reduced(ARCH))
    batch = make_lm_batch(task, 1, 4, 0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        train_codist(pm, CodistConfig(), TrainConfig(total_steps=1),
                     lambda k: {n: torch.stack([v, v]) for n, v in
                                batch.items()})
