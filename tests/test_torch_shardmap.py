"""``--mode codist-shardmap`` on ``torch.distributed``: one process per
model in a gloo pod group (``repro_torch.launch.mesh``), held against the
single-process ``PredictionExchange`` of the port and of the JAX reference
on the CPU, from the same weights and batches (numpy).

Two gloo pods are spawned once for the module (``spawn_pods``); each:

* trains its peer through ``ShardMapCompressed`` at period 1 and
  ``compression="none"``, 3 SGD-momentum steps: every History loss,
  ``distill_loss`` and per-model loss within 1e-5 relative of the port's
  ``PredictionExchange`` and of the reference's, the final parameters
  within 1e-5 of the port's;
* takes one step with each of the ``none``, ``topk`` and ``subsample``
  wires: the bytes that arrived through the all-gather equal
  ``core/comm_model.py``'s count and the loop's ``comm_bytes``;
* calls ``codist_loss`` with its pod group (``ShardMapCompressed``'s
  loss) on a top-k wire (the gated ``podlocal_codist_terms``) and on a
  full wire (the gathered-wire path):
  the per-model metrics equal the single-process ``codist_loss``, and the
  gradient of each pod's logits that pod's row of it.

Then the CLI (``--mode codist-shardmap --steps 3``) prints the lines of
``--mode codist``, a pod that raises fails the run with its traceback, and
the strategy refuses a pod group of another size than n.
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
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train import PredictionExchange as JPredictionExchange
from repro.train import build_train_step as jax_build_train_step
from repro.train.state import init_codist_state as jax_init_codist_state
from repro_torch.checkpoint import (params_from_jax, params_to_numpy,
                                    peer_params_from_jax,
                                    peer_params_to_numpy)
from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
from repro_torch.core import codistillation as cd
from repro_torch.core import comm_model as cm
from repro_torch.launch.mesh import PodGroup, spawn_pods
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train import (PredictionExchange, ShardMapCompressed,
                               resolve_strategy, train_codist)
from repro_torch.train.state import CodistState, TrainState, trainable_params

ARCH = "qwen1.5-0.5b"
N, B, S, STEPS = 2, 2, 8, 3
TC = dict(lr=0.05, warmup_steps=0, total_steps=STEPS, optimizer="sgdm",
          label_smoothing=0.1)
WIRES = {"none": {}, "topk": {"topk": 8}, "subsample": {"subsample": 4}}
TIMEOUT_S = 240.0


def _batches(cfg, steps, seed=3):
    rng = np.random.default_rng(seed)
    lead = (N, B, S)
    return [{"tokens": rng.integers(0, cfg.vocab_size, lead).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, lead).astype(np.int32),
             "mask": (rng.random(lead) > 0.2).astype(np.float32)}
            for _ in range(steps)]


def _loss_inputs(v, seed=4):
    """Every peer's logits, the labels and a mask, from numpy."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, B, S, v)).astype(np.float32)
    labels = rng.integers(0, v, (N, B, S)).astype(np.int32)
    mask = (rng.random((N, B, S)) > 0.3).astype(np.float32)
    return logits, labels, mask


def _codist_metrics(cfg, logits, labels, mask, pods=None):
    """codist_loss's per-model metrics and the gradient of the logits it
    was handed (this pod's alone with ``pods``)."""
    own = [pods.rank] if pods is not None else list(range(N))
    lg = [torch.from_numpy(logits[i]).requires_grad_(True) for i in own]
    total, met = cd.codist_loss(
        cfg, lg, torch.from_numpy(labels[own]), 0.7, 0.1,
        torch.from_numpy(mask[own]), pods=pods)
    total.backward()
    return ({k: met[k].detach().numpy() for k in
             ("loss", "task_loss_per_model", "distill_loss_per_model")},
            [g.grad.numpy() for g in lg])


def _pod_worker(pods, peers, batches):
    """One pod: the 3-step run, the one-step wire runs and codist_loss."""
    torch.manual_seed(0)
    cfg = get_reduced(ARCH)
    model = build_model(cfg)
    opt_init, _ = make_optimizer("sgdm")

    def run(codist, steps):
        params = trainable_params(params_from_jax(peers[pods.rank],
                                                  device="cpu"))
        before = pods.wire_bytes
        state, hist = train_codist(
            model, codist, TrainConfig(**{**TC, "total_steps": steps}),
            lambda k: {a: torch.from_numpy(v) for a, v in batches[k].items()},
            log_every=1, state=TrainState(params, opt_init(params), 0),
            strategy=ShardMapCompressed(codist, pods), device="cpu")
        return state, hist, pods.wire_bytes - before

    state, hist, _ = run(CodistConfig(n_models=N), STEPS)
    out = {"records": hist.records,
           "params": params_to_numpy(state.params), "wires": {}}
    for name, kw in WIRES.items():
        _s, h, nbytes = run(CodistConfig(n_models=N, compression=name, **kw),
                            1)
        out["wires"][name] = (nbytes, h.records[-1]["comm_bytes"])
    v = cfg.padded_vocab
    out["codist_loss"] = {
        name: _codist_metrics(CodistConfig(n_models=N, compression=name,
                                           topk=8),
                              *_loss_inputs(v), pods=pods)
        for name in ("topk", "none")}
    return out


def _raise_on_pod_one(pods):
    if pods.rank == 1:
        raise RuntimeError("pod one fails on purpose")
    return pods.rank


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file (a pod takes one of them), the
    caller's count restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def shared():
    """The reference's init (2 peers) and batches, as numpy."""
    jm = jax_build_model(jax_get_reduced(ARCH))
    j_init, _ = jax_make_optimizer("sgdm")
    jstate = jax_init_codist_state(jm, jax.random.key(0), N, j_init)
    stacked = jax.tree.map(np.asarray, jstate.params)
    peers = [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(N)]
    return jm, jstate, peers, _batches(get_reduced(ARCH), STEPS)


@pytest.fixture(scope="module")
def pods_out(shared):
    _jm, _js, peers, batches = shared
    return spawn_pods(_pod_worker, N, (peers, batches), device="cpu",
                      timeout_s=TIMEOUT_S)


def _close_rel(got, want, what, tol=1e-5):
    g, w = float(got), float(want)
    assert abs(g - w) <= tol * max(1.0, abs(w)), (what, g, w)


def test_three_steps_match_prediction_exchange(shared, pods_out):
    jm, jstate, peers, batches = shared
    cfg = get_reduced(ARCH)
    pm = build_model(cfg)
    # the port's single-process PredictionExchange from the same state
    codist = CodistConfig(n_models=N)
    params = trainable_params(peer_params_from_jax(
        jax.tree.map(np.asarray, jstate.params), N, device="cpu"))
    opt_init, _ = make_optimizer("sgdm")
    state, hist = train_codist(
        pm, codist, TrainConfig(**TC),
        lambda k: {a: torch.from_numpy(v) for a, v in batches[k].items()},
        log_every=1, state=CodistState(params, opt_init(params), 0),
        strategy=PredictionExchange(codist), device="cpu")
    # the reference's PredictionExchange
    jcd = JCodistConfig(n_models=N)
    jb = jax_build_train_step(jm, JTrainConfig(**TC), jcd,
                              JPredictionExchange(jcd))
    js = jstate
    jrecs = []
    for k, batch in enumerate(batches):
        js, met, _ = jb.apply(js, {a: jnp.asarray(v)
                                   for a, v in batch.items()}, k)
        jrecs.append(met)
    keys = ("loss", "task_loss", "distill_loss", "aux_loss",
            "task_loss_per_model_0", "task_loss_per_model_1",
            "distill_loss_per_model_0", "distill_loss_per_model_1",
            "comm_bytes")
    for r, pod in enumerate(pods_out):
        for k, (mine, single, ref) in enumerate(zip(
                pod["records"], hist.records, jrecs)):
            for key in keys:
                _close_rel(mine[key], single[key], (r, k, key))
            for key in ("loss", "task_loss", "distill_loss"):
                _close_rel(mine[key], float(ref[key]), (r, k, key, "ref"))
            assert mine["distill_loss"] > 0
    final = peer_params_to_numpy(state.params)
    for r, pod in enumerate(pods_out):
        got = jax.tree_util.tree_leaves_with_path(pod["params"])
        want = jax.tree.map(lambda a, r=r: a[r], final)
        for (path, g), w in zip(got, jax.tree.leaves(want)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"pod {r} {path}")


@pytest.mark.parametrize("wire", list(WIRES))
def test_metered_wire_bytes_equal_the_comm_model(pods_out, wire):
    cfg = get_reduced(ARCH)
    kw = WIRES[wire]
    bits = cm.prediction_bits_lm(cfg, S, 32, wire, kw.get("topk", 64),
                                 kw.get("subsample", 0))
    want = (N - 1) * bits * B / 8
    for pod in pods_out:
        nbytes, comm_bytes = pod["wires"][wire]
        assert nbytes == want == comm_bytes, (wire, nbytes, want, comm_bytes)


@pytest.mark.parametrize("wire", ["topk", "none"])
def test_codist_loss_with_pods_equals_single_process(pods_out, wire):
    cfg = CodistConfig(n_models=N, compression=wire, topk=8)
    logits, labels, mask = _loss_inputs(get_reduced(ARCH).padded_vocab)
    want, grads = _codist_metrics(cfg, logits, labels, mask)
    for r, pod in enumerate(pods_out):
        got, (g,) = pod["codist_loss"][wire]
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       err_msg=f"pod {r} {key}")
        np.testing.assert_allclose(g, grads[r], rtol=1e-5, atol=1e-9)


def test_cli_trains_as_codist(capsys):
    from repro_torch.launch.train import main
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "8",
            "--log-every", "1"]
    main(argv + ["--mode", "codist-shardmap"])
    shard = capsys.readouterr().out.splitlines()
    main(argv + ["--mode", "codist"])
    single = capsys.readouterr().out.splitlines()
    assert shard[-1].startswith("done: 3 steps")
    assert shard[:-1] == single[:-1] and len(shard) == 4


def test_a_failing_pod_fails_the_run():
    with pytest.raises(RuntimeError, match="pod 1 of 2 failed"):
        spawn_pods(_raise_on_pod_one, 2, device="cpu", timeout_s=TIMEOUT_S)


def test_pods_default_to_the_card_and_refuse_another_device():
    """``spawn_pods`` puts its pods on the card unless asked for the CPU,
    and a pod of the CLI refuses a ``--device`` other than its group's
    (no silent run on the group's device)."""
    import inspect
    from repro_torch.launch.train import shardmap_pod
    assert inspect.signature(spawn_pods).parameters["device"].default == "cuda"
    with pytest.raises(ValueError, match="pod group computes on cuda"):
        shardmap_pod(PodGroup(0, 2, torch.device("cuda")),
                     ["--mode", "codist-shardmap", "--device", "cpu"])


def test_strategy_needs_a_pod_group_of_n():
    """(Without any group: ``tests/test_torch_train.py``.)"""
    with pytest.raises(ValueError, match="3 models"):
        ShardMapCompressed(CodistConfig(n_models=3),
                           PodGroup(0, 2, torch.device("cpu")))
    pods = PodGroup(1, 2, torch.device("cpu"))
    assert isinstance(resolve_strategy(CodistConfig(), mesh=pods),
                      ShardMapCompressed)
