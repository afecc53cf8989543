"""The port's exchange mechanisms and compressed wires held against the JAX
reference, on shared weights and inputs (numpy, handed to both sides).

* ``codist_loss`` with ``fused=True`` (the reference runs its Pallas
  kernels in interpret mode, the port its kernels' plain versions): three
  peers (mse, kl: the first term from the combined kernel, the second from
  the standalone distillation kernels), a subsampled wire (mse, kl), a
  top-k wire on logits full of ties (mse, kl) and checkpoint-mode
  ``peer_pairwise`` targets. Per-peer task and distillation terms within
  1e-5 relative, the gradient of the total within 1e-5.
* ``_hierarchical_topk`` keeps the reference's index on ties, on its
  two-stage path and on its fallback.
* Three steps of ``PredictionExchange`` with three peers (mse, kl),
  ``CheckpointExchange`` with two peers and period 2 (each peer its own
  batch; a stale refresh at steps 0 and 2), and ``PipelinedPredictions``
  with two peers, against the reference's: per-step losses within 1e-5
  relative, the parameters after SGD-momentum within 1e-5.
* The CLI trains on the CPU with three peers, the checkpoint and pipelined
  modes and the top-k and subsample wires; ``--out`` writes ``final.npz`` +
  ``final.tree.json``, which the reference's ``load_pytree`` reads.
* ``checkpoint/io.py``: a port checkpoint loads into the reference's
  template and back, leaf for leaf; a save interrupted before its
  ``os.replace`` leaves the previous checkpoint whole.
"""
import json

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
from repro.core import codistillation as jcd
from repro.models import build_model as jax_build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train import build_train_step as jax_build_train_step
from repro.train import resolve_strategy as jax_resolve_strategy
from repro.train.state import init_codist_state as jax_init_codist_state
from repro_torch.checkpoint import (load_pytree, opt_state_from_jax,
                                    peer_params_from_jax, peer_params_to_numpy,
                                    save_pytree)
from repro_torch.checkpoint import io as port_io
from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
from repro_torch.core import codistillation as cd
from repro_torch.models import build_model
from repro_torch.train import (CheckpointExchange, PipelinedPredictions,
                               PredictionExchange, build_train_step,
                               resolve_strategy)
from repro_torch.train.state import CodistState, trainable_params

torch.set_num_threads(2)

ARCH = "qwen1.5-0.5b"
B, S, V = 2, 8, 320


def _close_rel(got, want, tol=1e-5):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(g - w) <= tol * np.maximum(1.0, np.abs(w))), (g, w)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------------------
# codist_loss on shared logits
# ----------------------------------------------------------------------------

LOSS_CASES = {
    "n3-mse": (3, dict(distill_loss="mse")),
    "n3-kl": (3, dict(distill_loss="kl")),
    "subsample-mse": (2, dict(compression="subsample", subsample=4)),
    "subsample-kl": (3, dict(compression="subsample", subsample=3,
                             distill_loss="kl")),
    "topk-mse": (2, dict(compression="topk", topk=8)),
    "topk-kl": (2, dict(compression="topk", topk=8, distill_loss="kl")),
    "pairwise": (3, dict()),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_codist_loss_matches_reference(case):
    n, kw = LOSS_CASES[case]
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((n, B, S, V)) * 2).astype(np.float32)
    if case.startswith("topk"):
        # halves: many equal values, ties at the k-th place included
        logits = (np.round(logits * 2) / 2).astype(np.float32)
    labels = rng.integers(0, V, size=(n, B, S)).astype(np.int32)
    mask = (rng.random((n, B, S)) > 0.2).astype(np.float32)
    pairwise = (rng.standard_normal((n, n, B, S, V)) * 2).astype(np.float32)
    jcfg, pcfg = JCodistConfig(n_models=n, **kw), CodistConfig(n_models=n, **kw)
    extra = case == "pairwise"

    def jloss(lg):
        return jcd.codist_loss(
            jcfg, lg, jnp.asarray(labels), 0.7, 0.1, jnp.asarray(mask),
            peer_pairwise=jnp.asarray(pairwise) if extra else None,
            fused=True)

    (jtotal, jm), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    lg = [_t(x).requires_grad_(True) for x in logits]
    total, pm = cd.codist_loss(
        pcfg, lg, _t(labels), 0.7, 0.1, _t(mask),
        peer_pairwise=_t(pairwise) if extra else None, fused=True)
    total.backward()
    for key in ("task_loss_per_model", "distill_loss_per_model"):
        _close_rel(pm[key].detach().numpy(), jm[key])
    _close_rel(float(total.detach()), float(jtotal))
    assert float(pm["distill_loss"].detach()) > 0
    for i in range(n):
        np.testing.assert_allclose(lg[i].grad.numpy(), np.asarray(jgrad[i]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("v,segments", [(256, 16), (100, 16)])
def test_topk_keeps_the_reference_index_on_ties(v, segments):
    """(256, 16): the two-stage path; (100, 16): the fallback (100 is no
    multiple of 16). Values in steps of 1/2, so ties are everywhere."""
    rng = np.random.default_rng(11)
    x = (np.round(rng.standard_normal((3, 5, v)) * 2) / 2).astype(np.float32)
    jv, ji = jcd._hierarchical_topk(jnp.asarray(x), 8, segments=segments)
    pv, pi = cd._hierarchical_topk(_t(x), 8, segments=segments)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    # the ties really are there: the k-th value repeats beyond the top-k
    kth = pv[..., -1:]
    assert bool(((_t(x) == kth).sum(-1) > (pv == kth).sum(-1)).any())


# ----------------------------------------------------------------------------
# three training steps on both sides
# ----------------------------------------------------------------------------

def _batches(cfg, n, steps, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        lead = (n, B, S)
        out.append({
            "tokens": rng.integers(0, cfg.vocab_size, size=lead).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, size=lead).astype(np.int32),
            "mask": (rng.random(lead) > 0.2).astype(np.float32)})
    return out


STEP_CASES = {
    "prediction-n3-mse": (3, dict(distill_loss="mse"), PredictionExchange),
    "prediction-n3-kl": (3, dict(distill_loss="kl"), PredictionExchange),
    "checkpoint-period2": (2, dict(mode="checkpoints", period=2),
                           CheckpointExchange),
    "pipelined": (2, dict(pipelined=True), PipelinedPredictions),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_match_reference(case):
    n, ckw, cls = STEP_CASES[case]
    steps = 3
    jc, pc = jax_get_reduced(ARCH), get_reduced(ARCH)
    jm, pm = jax_build_model(jc), build_model(pc)
    kw = dict(lr=0.05, warmup_steps=0, total_steps=steps, optimizer="sgdm",
              label_smoothing=0.1, fused_losses=True)
    jtc, ptc = JTrainConfig(**kw), TrainConfig(**kw)
    jcd_, pcd = JCodistConfig(n_models=n, **ckw), CodistConfig(n_models=n, **ckw)
    jst, pst = jax_resolve_strategy(jcd_), resolve_strategy(pcd)
    assert isinstance(pst, cls) and type(jst).__name__ == cls.__name__
    j_init, _ = jax_make_optimizer("sgdm")
    batches = _batches(pc, n, steps)
    jex = {a: jnp.asarray(v) for a, v in batches[0].items()}
    pex = {a: _t(v) for a, v in batches[0].items()}
    jstate = jax_init_codist_state(jm, jax.random.key(0), n, j_init)
    jstate = jst.ensure_state(jstate, jm, jtc, jex)
    pstate = CodistState(
        trainable_params(peer_params_from_jax(
            jax.tree.map(np.asarray, jstate.params), n, device="cpu")),
        opt_state_from_jax(jstate.opt, n, device="cpu"), 0)
    pstate = pst.ensure_state(pstate, pm, ptc, pex)
    jb = jax_build_train_step(jm, jtc, jcd_, jst)
    pb = build_train_step(pm, ptc, pcd, pst)
    keys = ("loss", "task_loss", "distill_loss")
    exchanges = []
    for k, batch in enumerate(batches):
        jstate, jmet, jplan = jb.apply(
            jstate, {a: jnp.asarray(v) for a, v in batch.items()}, k)
        pstate, pmet, pplan = pb.apply(
            pstate, {a: _t(v) for a, v in batch.items()}, k)
        assert (jplan.distill, jplan.exchange) == (pplan.distill,
                                                   pplan.exchange)
        exchanges.append(pplan.exchange)
        for key in keys:
            _close_rel(float(pmet[key]), float(jmet[key]))
        assert float(pmet["distill_loss"]) > 0 or (case == "pipelined"
                                                   and k == 0)
    if case == "checkpoint-period2":
        assert exchanges == [True, False, True]
    if case == "pipelined":
        assert pstate.peer["valid"] is True
    assert pstate.step == int(jstate.step) == steps
    want = jax.tree.map(np.asarray, jstate.params)
    got = peer_params_to_numpy(pstate.params)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=str(path))


def test_strategy_state_and_refresh():
    """The checkpoint strategy's replicas start equal to the parameters and
    are refreshed in place; the pipelined buffer is fp32 and invalid until
    the first step."""
    from repro_torch.optim import make_optimizer
    from repro_torch.train import refresh_stale
    pm = build_model(get_reduced(ARCH))
    tc = TrainConfig(total_steps=1)
    gen = torch.Generator()
    gen.manual_seed(0)
    opt_init, _ = make_optimizer("sgdm")
    ex = {a: _t(v) for a, v in _batches(get_reduced(ARCH), 2, 1)[0].items()}
    ck = CheckpointExchange(CodistConfig(mode="checkpoints"))
    st = ck.init_state(pm, tc, gen, opt_init, ex, device="cpu")
    leaf = st.params[0]["embed"]["tokens"]
    stale_leaf = st.stale[0]["embed"]["tokens"]
    assert torch.equal(stale_leaf, leaf) and not stale_leaf.requires_grad
    with torch.no_grad():
        leaf.add_(1.0)
    st = refresh_stale(st)
    assert st.stale[0]["embed"]["tokens"] is stale_leaf
    assert torch.equal(stale_leaf, leaf)
    pp = PipelinedPredictions(CodistConfig(pipelined=True))
    st = pp.init_state(pm, tc, gen, opt_init, ex, device="cpu")
    assert st.peer["valid"] is False
    assert st.peer["logits"].dtype == torch.float32
    assert tuple(st.peer["logits"].shape) == (2, B, S,
                                              get_reduced(ARCH).padded_vocab)


# ----------------------------------------------------------------------------
# the CLI and the checkpoint format
# ----------------------------------------------------------------------------

def _path_get(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


@pytest.mark.parametrize("argv", [
    ["--codist-n", "3", "--out", "OUT"],
    ["--mode", "codist-ckpt", "--period", "2"],
    ["--mode", "codist-pipelined", "--distill-loss", "kl"],
    ["--compression", "topk", "--topk", "8"],
    ["--compression", "subsample"]])
def test_cli_trains_new_modes_on_cpu(argv, capsys, tmp_path):
    from repro_torch.launch.train import main
    argv = [str(tmp_path) if a == "OUT" else a for a in argv]
    main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "8",
          "--log-every", "1", "--fused-losses", "on", *argv])
    out = capsys.readouterr().out
    assert "step=1 task_loss=" in out and "done: 2 steps" in out
    assert "nan" not in out.lower()
    if "--out" not in argv:
        return
    assert (tmp_path / "history.json").exists()
    doc = json.loads((tmp_path / "final.tree.json").read_text())
    jm = jax_build_model(jax_get_reduced(ARCH))
    j_init, _ = jax_make_optimizer("adamw")
    like = jax_init_codist_state(jm, jax.random.key(1), 3, j_init).params
    loaded = jax_load_pytree(str(tmp_path / "final"), like)
    flat = jax.tree_util.tree_flatten_with_path(like)[0]
    assert doc["n_leaves"] == len(flat)
    for path, want in flat:
        got = _path_get(loaded, path)
        assert got.shape == want.shape, path
        assert bool(jnp.isfinite(got).all()), path


def test_checkpoint_round_trips_with_the_reference(tmp_path):
    """Port save -> reference load, and reference save -> port load, leaf
    for leaf (the leaves differ in shape, so an order mismatch shows)."""
    pc, jc = get_reduced(ARCH), jax_get_reduced(ARCH)
    pm, jm = build_model(pc), jax_build_model(jc)
    gen = torch.Generator()
    gen.manual_seed(3)
    peers = [pm.init(gen, device="cpu") for _ in range(2)]
    tree = peer_params_to_numpy(peers)
    save_pytree(str(tmp_path / "port"), tree, meta={"step": 4})
    assert port_io.read_meta(str(tmp_path / "port")) == {"step": 4}
    j_init, _ = jax_make_optimizer("sgdm")
    like = jax_init_codist_state(jm, jax.random.key(0), 2, j_init).params
    loaded = jax_load_pytree(str(tmp_path / "port"), like)
    for path, got in jax.tree_util.tree_flatten_with_path(loaded)[0]:
        np.testing.assert_array_equal(np.asarray(got), _path_get(tree, path))
    jax_save_pytree(str(tmp_path / "ref"), like)
    back = load_pytree(str(tmp_path / "ref"),
                       peer_params_to_numpy([pm.init(gen, device="cpu")] * 2))
    for path, want in jax.tree_util.tree_flatten_with_path(like)[0]:
        np.testing.assert_array_equal(_path_get(back, path), np.asarray(want))
    # tensors in the template: restored as tensors of its dtype
    tlike = peer_params_to_numpy(peers)
    tlike["embed"]["tokens"] = torch.zeros(tlike["embed"]["tokens"].shape,
                                           dtype=torch.bfloat16)
    tback = load_pytree(str(tmp_path / "ref"), tlike)
    assert tback["embed"]["tokens"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tback["embed"]["tokens"].float().numpy(),
        np.asarray(jnp.asarray(like["embed"]["tokens"]).astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def test_interrupted_save_leaves_the_previous_checkpoint(tmp_path,
                                                         monkeypatch):
    path = str(tmp_path / "ck")
    old = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
           "b": [np.ones(4, np.float32)]}
    save_pytree(path, old, meta={"step": 1})
    calls = []

    def failing_replace(src, dst):
        calls.append(dst)
        raise OSError("interrupted")

    monkeypatch.setattr(port_io.os, "replace", failing_replace)
    new = {"a": -np.ones((2, 3), np.float32), "b": [np.zeros(4, np.float32)]}
    with pytest.raises(OSError, match="interrupted"):
        save_pytree(path, new, meta={"step": 2})
    monkeypatch.undo()
    assert calls == [path + ".npz"]        # the payload goes first
    got = load_pytree(path, new)
    np.testing.assert_array_equal(got["a"], old["a"])
    np.testing.assert_array_equal(got["b"][0], old["b"][0])
    assert port_io.read_meta(path) == {"step": 1}
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(path, {"a": old["a"]})
