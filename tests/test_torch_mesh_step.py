"""The codist step on a (pod, data, model) mesh: one peer a pod, its state
and batch DTensors on the pod's ("data", "model") devices (FSDP over
"data", TP over "model"), eight gloo ranks on the CPU, held against the
single-device step of the port and of the JAX reference from the same
weights (``checkpoint/bridge.py``) and numpy batches.

The reference's own test (``tests/test_distributed.py``) runs its
``PredictionExchange`` step under ``jax.jit`` with ``in_shardings`` on
``make_host_mesh((2, 2, 2))`` at qwen1.5-0.5b cut to 2 layers, d 64, d_ff
128, V 64, 2 heads of 32, SGD-momentum at lr 1e-2, 2 models of 4 x 16
tokens. Eight ranks are spawned once (``spawn_pods(..., mesh=)``, one
intra-op thread each); each runs ``ShardMapCompressed`` (what the
reference's ``resolve_strategy`` gives for a mesh) on that mesh and on
(2, 1, 4), where 2 heads over a 4-way TP slide to the head dim, with the
full wire and a top-k wire, 3 steps each, with the loss kernels' DTensor
entry (``fused_losses=True``: their plain versions inside ``local_map``).
Each rank reports its History, its peer's full parameters, the shapes of
its local shards and the bytes its pod gather metered; it also holds
``PredictionExchange`` with both peers on its pod's ("data", "model")
devices (a (1, 2, 2) mesh, on which the pod axis is not n and the peer
axis stays unplaced), feeds a DTensor to the kernel wrappers, and calls
``hint``. The reference is imported in the test process only: the ranks
import this module, and no JAX.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import params_from_jax, peer_params_from_jax
from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
from repro_torch.core import comm_model as cm
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (device_mesh, make_host_mesh,
                                     mesh_pod_group, spawn_pods)
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train import (History, PredictionExchange,
                               ShardMapCompressed, build_train_step)
from repro_torch.train.state import CodistState, TrainState, trainable_params
from repro_torch.tree import tree_map

ARCH = "qwen1.5-0.5b"
CUT = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64, num_heads=2,
           num_kv_heads=2, head_dim=32)
N, B, S, STEPS = 2, 4, 16, 3
TC = dict(lr=1e-2, total_steps=10, warmup_steps=0, optimizer="sgdm")
MESHES = [(2, 2, 2), (2, 1, 4)]
ONE_POD = (1, 2, 2)
WIRES = {"none": {}, "topk": {"topk": 8}}
CASES = [(m, w) for m in MESHES for w in WIRES]
TIMEOUT_S = 480.0


def _cfg():
    return replace(get_reduced(ARCH), **CUT)


def _batches(steps, seed=5):
    rng = np.random.default_rng(seed)
    lead = (N, B, S)
    return [{"tokens": rng.integers(0, CUT["vocab_size"], lead).astype(np.int32),
             "labels": rng.integers(0, CUT["vocab_size"], lead).astype(np.int32),
             "mask": (rng.random(lead) > 0.2).astype(np.float32)}
            for _ in range(steps)]


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _codist(wire):
    return CodistConfig(n_models=N, compression=wire, **WIRES[wire])


def _full(tree):
    return tree_map(lambda x: x.full_tensor().detach().numpy(), tree)


def _locals(state):
    """(path, global shape, local shape) of every parameter and moment
    leaf of a one-peer state."""
    tree = {"params": state.params, "opt": {"m": state.opt.m, "v": None}}
    return [(p, tuple(x.shape), tuple(x.to_local().shape))
            for p, x in sh.tree_flatten_with_path(tree)]


def _steps(model, codist, strategy, state, batches, place=None):
    """``STEPS`` steps of ``strategy``'s step at the reference test's
    TrainConfig (a 10-step schedule; the loss kernels' DTensor entry
    where the state is on a mesh): (History records, final state)."""
    tc = TrainConfig(**TC, fused_losses=True)
    bundle = build_train_step(model, tc, codist, strategy)
    state = strategy.ensure_state(state, model, tc)
    hist = History()
    for k in range(STEPS):
        batch = _torch_batch(batches[k])
        state, met, _plan = bundle.apply(
            state, batch if place is None else place(batch), k)
        hist.log(k, met)
    return hist.records, state


def _sharded_run(pods, wire, peers, batches):
    """One ``ShardMapCompressed`` run of this rank's pod's peer."""
    opt_init, _ = make_optimizer("sgdm")
    params = trainable_params(params_from_jax(peers[pods.rank], device="cpu"))
    codist = _codist(wire)
    bytes0 = pods.wire_bytes
    records, state = _steps(build_model(_cfg()), codist,
                            ShardMapCompressed(codist, pods),
                            TrainState(params, opt_init(params), 0), batches)
    return {"records": records, "pod": pods.rank,
            "params": _full(state.params), "locals": _locals(state),
            "wire_bytes": pods.wire_bytes - bytes0}


def _one_pod_run(pods, peers, batches):
    """PredictionExchange with both peers on this rank's pod's devices,
    placed by the rules on ``ONE_POD`` (each pod runs it alone)."""
    mesh = make_host_mesh(ONE_POD)
    opt_init, _ = make_optimizer("sgdm")
    params = trainable_params(peer_params_from_jax(
        _stack_peers(peers), N, device="cpu"))
    state = sh.distribute_state(CodistState(params, opt_init(params), 0),
                                mesh, pods.sub_mesh, N)
    codist = _codist("none")
    records, state = _steps(
        build_model(_cfg()), codist, PredictionExchange(codist), state,
        batches, lambda b: sh.distribute_batch(b, mesh, pods.sub_mesh))
    return {"records": records,
            "params": [_full(p) for p in state.params]}


def _stack_peers(peers):
    """The peers' numpy trees stacked on a leading axis (the reference's
    layout, which ``peer_params_from_jax`` splits)."""
    return {k: (_stack_peers([p[k] for p in peers]) if isinstance(v, dict)
                else np.stack([p[k] for p in peers]))
            for k, v in peers[0].items()}


def _wrappers_refuse(pods) -> list:
    """The error of each kernel wrapper handed DTensor logits directly."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import (fused_ce_distill_parts,
                                     fused_cross_entropy_parts,
                                     fused_distill_loss)
    mesh = pods.sub_mesh
    rep = [Replicate()] * mesh.ndim
    x = distribute_tensor(torch.randn(8, 64), mesh, rep)
    lab = distribute_tensor(torch.zeros(8, dtype=torch.int32), mesh, rep)
    out = []
    for call in (lambda: fused_cross_entropy_parts(x, lab),
                 lambda: fused_ce_distill_parts(x, x, lab),
                 lambda: fused_distill_loss(x, x, "mse")):
        try:
            call()
            out.append(None)
        except TypeError as e:
            out.append(str(e))
    return out


def _distill_entry(pods) -> dict:
    """``ops.fused_distill_mean`` (one output a row) on DTensor logits
    (rows over "data", V over "model") against the same call on the full
    tensors: |mean difference| and the student's gradient's largest
    difference, for mse and kl."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.ops import fused_distill_mean
    mesh = pods.sub_mesh
    g = torch.Generator().manual_seed(11)
    x = torch.randn(4, 16, 64, generator=g)
    t = torch.randn(4, 16, 64, generator=g)
    m = (torch.rand(4, 16, generator=g) > 0.3).float()
    pl = [Shard(0), Shard(2)]
    out = {}
    for mode in ("mse", "kl"):
        xd = distribute_tensor(x, mesh, pl).requires_grad_(True)
        got = fused_distill_mean(xd, distribute_tensor(t, mesh, pl), mode,
                                 distribute_tensor(m, mesh,
                                                   [Shard(0), Replicate()]))
        got.backward()
        xp = x.clone().requires_grad_(True)
        want = fused_distill_mean(xp, t, mode, m)
        want.backward()
        out[mode] = (float((got.full_tensor() - want).abs()),
                     float((xd.grad.full_tensor() - xp.grad).abs().max()))
    return out


def _hints(pods) -> dict:
    from torch.distributed.tensor import Partial, distribute_tensor
    from repro_torch.models.sharding_hints import (activation_sharding,
                                                   current_hint_spec, hint)
    mesh = pods.sub_mesh
    plain = torch.randn(4, 16, 64)
    x = distribute_tensor(torch.randn(4, 16, 256), mesh,
                          [Partial(), Partial()])
    with activation_sharding(("data",), "model", mesh.size(1)):
        same = hint(plain, "btv") is plain
        y = hint(x, "btv")
        want = sh.placements(current_hint_spec("btv", y.shape), mesh)
        scores = hint(distribute_tensor(torch.randn(4, 2, 16, 16), mesh,
                                        [Partial(), Partial()]), "scores")
        s_want = sh.placements(current_hint_spec("scores", scores.shape),
                               mesh)
    return {"plain_untouched": same,
            "btv": (str(tuple(y.placements)), str(want)),
            "btv_value": float((y.full_tensor() - x.full_tensor()).abs().max()),
            "scores": (str(tuple(scores.placements)), str(s_want)),
            "outside": hint(x, "btv") is x}


def _mesh_worker(pods, peers, batches):
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    out = {"runs": {}}
    groups = {MESHES[0]: pods}
    for shape in MESHES[1:]:
        m = make_host_mesh(shape)
        groups[shape] = mesh_pod_group(m, device_mesh(m, "cpu"), pods.device)
    for shape, wire in CASES:
        out["runs"][(shape, wire)] = _sharded_run(groups[shape], wire, peers,
                                                  batches)
    out["one_pod"] = _one_pod_run(pods, peers, batches)
    out["refused"] = _wrappers_refuse(pods)
    out["distill_entry"] = _distill_entry(pods)
    out["hints"] = _hints(pods)
    return out


@pytest.fixture(scope="module")
def shared():
    """The reference's init (2 peers) and the numpy batches."""
    import jax
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model
    from repro.optim import make_optimizer as jax_make_optimizer
    from repro.train.state import init_codist_state as jax_init_codist_state
    jm = jax_build_model(replace(jax_get_reduced(ARCH), **CUT))
    j_init, _ = jax_make_optimizer("sgdm")
    jstate = jax_init_codist_state(jm, jax.random.key(0), N, j_init)
    stacked = jax.tree.map(np.asarray, jstate.params)
    peers = [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(N)]
    return jm, jstate, peers, _batches(STEPS)


@pytest.fixture(scope="module")
def ranks(shared):
    _jm, _js, peers, batches = shared
    before = torch.get_num_threads()
    torch.set_num_threads(8)          # 8 ranks, one intra-op thread each
    try:
        return spawn_pods(_mesh_worker, 8, (peers, batches), device="cpu",
                          timeout_s=TIMEOUT_S, mesh=make_host_mesh(MESHES[0]))
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def single(shared):
    """wire -> (History records, final peer trees) of the port's
    single-device PredictionExchange (the loss kernels' plain versions)."""
    _jm, _jstate, peers, batches = shared
    out = {}
    for wire in WIRES:
        params = trainable_params(peer_params_from_jax(
            _stack_peers(peers), N, device="cpu"))
        opt_init, _ = make_optimizer("sgdm")
        codist = _codist(wire)
        records, state = _steps(build_model(_cfg()), codist,
                                PredictionExchange(codist),
                                CodistState(params, opt_init(params), 0),
                                batches)
        out[wire] = (records, [tree_map(lambda x: x.detach().numpy(), p)
                               for p in state.params])
    return out


@pytest.fixture(scope="module")
def reference(shared):
    """wire -> (losses, final stacked params) of the reference's
    single-device ``jax.jit(step)``, 3 steps."""
    import jax
    import jax.numpy as jnp
    from repro.configs import CodistConfig as JCodistConfig
    from repro.configs import TrainConfig as JTrainConfig
    from repro.train import PredictionExchange as JPredictionExchange
    from repro.train import build_train_step as jax_build_train_step
    jm, jstate, _peers, batches = shared
    out = {}
    for wire in WIRES:
        jcd = JCodistConfig(n_models=N, compression=wire, **WIRES[wire])
        step = jax.jit(jax_build_train_step(
            jm, JTrainConfig(**TC), jcd,
            JPredictionExchange(jcd)).variants["on"])
        js, losses = jstate, []
        for batch in batches:
            js, met = step(js, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(met["loss"]))
        out[wire] = (losses, jax.tree.map(np.asarray, js.params))
    return out


def _rel(a, b):
    return abs(float(a) - float(b)) / max(1.0, abs(float(b)))


def _case_id(case):
    return f"{'x'.join(map(str, case[0]))}-{case[1]}"


def _assert_trees_close(got, want, atol, what):
    """Every leaf of ``got`` within ``atol`` of ``want``'s, by path."""
    g, w = (dict(sh.tree_flatten_with_path(t)) for t in (got, want))
    assert g.keys() == w.keys(), what
    for path in g:
        np.testing.assert_allclose(g[path], w[path], rtol=0, atol=atol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_step_matches_the_single_device_step(ranks, single, case):
    """Every rank's losses within 1e-5 relative and its pod's peer within
    1e-5 of the port's single-device PredictionExchange."""
    records, final = single[case[1]]
    for r, rank in enumerate(ranks):
        run = rank["runs"][case]
        assert len(run["records"]) == STEPS
        for mine, want in zip(run["records"], records):
            for key in ("loss", "task_loss", "distill_loss",
                        "task_loss_per_model_0", "task_loss_per_model_1",
                        "distill_loss_per_model_0",
                        "distill_loss_per_model_1"):
                assert _rel(mine[key], want[key]) <= 1e-5, (r, key)
            assert mine["distill_loss"] > 0
        _assert_trees_close(run["params"], final[run["pod"]], 1e-5,
                            f"rank {r}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_step_matches_the_reference(ranks, reference, case):
    """Within 1e-4 of the reference's single-device ``jax.jit(step)`` (its
    sharded case is red on jax 0.9.0, so its single-device step is the
    yardstick): the losses relative, every leaf absolute."""
    losses, stacked = reference[case[1]]
    for r, rank in enumerate(ranks):
        run = rank["runs"][case]
        for mine, want in zip(run["records"], losses):
            assert _rel(mine["loss"], want) <= 1e-4, (r, mine["step"])
        _assert_trees_close(run["params"],
                            tree_map(lambda a, p=run["pod"]: a[p], stacked),
                            1e-4, f"rank {r} vs the reference")


@pytest.mark.parametrize("shape", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_local_shards_follow_the_rules(ranks, shape):
    """On every rank each parameter and moment leaf's local shard is
    ``local_shape`` of its spec (``state_shardings`` of the stacked state,
    the peer axis on "pod"), and the rank holds its own pod's peer."""
    mesh = make_host_mesh(shape)
    for r, rank in enumerate(ranks):
        run = rank["runs"][(shape, "none")]
        assert run["pod"] == r // (8 // shape[0])
        for path, full, local in run["locals"]:
            stacked = torch.empty((N, *full), device="meta")
            name = path.replace("opt/m/", "")
            spec = sh.param_spec(name, tuple(stacked.shape), mesh,
                                 stacked=True, scanned=sh._scanned(name))
            assert spec[0] == "pod", (path, spec)
            assert local == sh.local_shape(full, spec[1:], mesh), (r, path)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_pod_gather_bytes_equal_comm_bytes(ranks, case):
    """The bytes the pod gathers metered (each shard once a pod) sum, over
    a pod's ranks, to ``comm_model``'s count of the other peer's wire."""
    cfg = _cfg()
    kw = WIRES[case[1]]
    bits = cm.prediction_bits_lm(cfg, S, 32, case[1], kw.get("topk", 64))
    want = STEPS * (N - 1) * bits * B / 8
    for pod in range(N):
        got = sum(rk["runs"][case]["wire_bytes"] for rk in ranks
                  if rk["runs"][case]["pod"] == pod)
        assert got == want, (pod, got, want)


def test_prediction_exchange_on_one_pod(ranks, single):
    """Both peers as DTensors on one pod of (1, 4, 2) (the pod axis is not
    n, so the peer axis is unplaced): ``PredictionExchange`` equals the
    single-device step."""
    records, final = single["none"]
    for r, rank in enumerate(ranks):
        got = rank["one_pod"]
        for mine, want in zip(got["records"], records):
            for key in ("loss", "task_loss", "distill_loss"):
                assert _rel(mine[key], want[key]) <= 1e-5, (r, key)
        for i in range(N):
            _assert_trees_close(got["params"][i], final[i], 1e-5,
                                f"rank {r} peer {i}")


def test_kernel_wrappers_refuse_dtensors(ranks):
    for rank in ranks:
        assert all(msg and "DTensor" in msg for msg in rank["refused"]), \
            rank["refused"]


def test_distill_mean_on_local_rows(ranks):
    """The one-output entry (``_DistillTokens``: a third peer's term, a
    subsampled wire's) on DTensor logits equals the plain call."""
    for rank in ranks:
        for mode, (val, grad) in rank["distill_entry"].items():
            assert val <= 1e-6 and grad <= 1e-7, (mode, val, grad)


def test_hint_places_dtensors_and_leaves_plain_tensors(ranks):
    for rank in ranks:
        h = rank["hints"]
        assert h["plain_untouched"] and h["outside"]
        assert h["btv"][0] == h["btv"][1]
        assert h["scores"][0] == h["scores"][1]
        assert h["btv_value"] == 0.0
