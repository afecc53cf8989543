"""The all-reduce baseline and microbatches on a (pod, data, model) mesh,
the cross-pod traffic of both strategies, and the rwkv6 and VLM codist
steps on the mesh: eight gloo ranks on the CPU, held against the
single-device step of the port and of the JAX reference from the same
weights (``checkpoint/bridge.py``) and numpy batches.

``AllReduce`` places one model over every rank, as the reference's dry
run lowers it (``launch/dryrun.py`` ``_train_lowering``): its state by
``state_shardings(..., stacked=False)`` (FSDP over "data", TP over
"model", replicated over "pod"), its batch rows over ("pod", "data"); the
gradient's sum over the pods is reduced in the optimizer and metered
there (``optim/optimizers.py`` ``pod_sync``). It runs at the reference's
traffic-test model (``tests/test_distributed.py``: qwen1.5-0.5b cut to 2
layers, d 64, d_ff 128, V 64, 2 heads of 32, SGD-momentum at lr 1e-2, 8 x
16 tokens) on (2, 2, 2) and on (1, 2, 4), where 2 heads do not divide the
4-way TP while the batch is split too, and with 2 microbatches of 8 x 16
on (2, 2, 2). ``ShardMapCompressed`` (one peer a pod, 2 models of 4 x 16)
runs on (2, 2, 2), with 2 microbatches of 4 x 16 too, and so do the
reduced rwkv6-1.6b and internvl2-76b (with numpy patches, placed by
``distribute_batch``), cut to the same widths. A microbatch has the shape
of the unsplit batch, so DTensor plans its step from the cache its first
run filled. Eight ranks are spawned once
(``spawn_pods(..., mesh=)``, one intra-op thread each), with the loss
kernels' DTensor entry (``fused_losses=True``: their plain versions inside
``local_map``). The reference is imported in the test process only, and
each of its jits is built once.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import params_from_jax, peer_params_from_jax
from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import sharding as sh
from repro_torch.launch.cost import step_cost
from repro_torch.launch.mesh import device_mesh, make_host_mesh, spawn_pods
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer, optimizers
from repro_torch.train import (AllReduce, History, PredictionExchange,
                               ShardMapCompressed, build_train_step,
                               resolve_strategy)
from repro_torch.train.state import CodistState, TrainState, trainable_params
from repro_torch.tree import tree_map

CUT = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64)
ARCHS = {"qwen1.5-0.5b": dict(num_heads=2, num_kv_heads=2, head_dim=32),
         "rwkv6-1.6b": dict(num_heads=2, num_kv_heads=2, head_dim=32),
         "internvl2-76b": dict(num_heads=2, num_kv_heads=1, head_dim=32,
                               num_patches=8)}
DENSE = "qwen1.5-0.5b"
N, B_PEER, B, S, STEPS = 2, 4, 8, 16, 3
TC = dict(lr=1e-2, total_steps=10, warmup_steps=0, optimizer="sgdm")
MESH = (2, 2, 2)
TP4 = (1, 2, 4)
# (mesh, microbatches) of the AllReduce runs; (arch, microbatches) of the
# ShardMapCompressed runs on MESH
AR_CASES = [(MESH, 1), (TP4, 1), (MESH, 2)]
CODIST_CASES = [(DENSE, 1), (DENSE, 2), ("rwkv6-1.6b", 1),
                ("internvl2-76b", 1)]
TIMEOUT_S = 600.0


def _cfg(arch):
    return replace(get_reduced(arch), **CUT, **ARCHS[arch])


def _batches(arch, lead, seed, k=1):
    """``STEPS`` numpy batches of ``lead`` rows (a VLM's with patches), k
    times as many in the last lead dim for k microbatches."""
    cfg = _cfg(arch)
    lead = (*lead[:-1], k * lead[-1])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, CUT["vocab_size"],
                                    (*lead, S)).astype(np.int32),
             "labels": rng.integers(0, CUT["vocab_size"],
                                    (*lead, S)).astype(np.int32),
             "mask": (rng.random((*lead, S)) > 0.2).astype(np.float32)}
        if cfg.num_patches:
            b["patches"] = (0.1 * rng.standard_normal(
                (*lead, cfg.num_patches, cfg.d_model))).astype(np.float32)
        out.append(b)
    return out


def _micro(batches, k, lead_axes):
    """Each leaf's batch dim (after ``lead_axes`` leading axes) split into
    (k, B/k): the engine's microbatched layout."""
    if k == 1:
        return batches
    def one(v):
        a = lead_axes
        return v.reshape(*v.shape[:a], k, v.shape[a] // k, *v.shape[a + 1:])
    return [{n: one(v) for n, v in b.items()} for b in batches]


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _codist():
    return CodistConfig(n_models=N)


def _full(tree):
    return tree_map(lambda x: x.full_tensor().detach().numpy(), tree)


def _steps(model, codist, strategy, state, batches, k):
    """``STEPS`` steps at the reference test's TrainConfig with k
    microbatches: (History records, final state)."""
    tc = TrainConfig(**TC, fused_losses=True, microbatch=k)
    bundle = build_train_step(model, tc, codist, strategy)
    state = strategy.ensure_state(state, model, tc)
    hist = History()
    for step, batch in enumerate(batches):
        state, met, _plan = bundle.apply(state, _torch_batch(batch), step)
        hist.log(step, met)
    return hist.records, state


def _ar_run(dm, mesh, params, batches, k):
    """``AllReduce`` over every rank of ``dm``: its records, full
    parameters, local shard shapes and the cross-pod bytes it metered."""
    opt_init, _ = make_optimizer("sgdm")
    strategy = resolve_strategy(None, dm)
    state = strategy.ensure_state(
        TrainState(trainable_params(params_from_jax(params, device="cpu")),
                   optimizers.OptState(0, None, None), 0), None, None)
    state = state._replace(opt=opt_init(state.params))
    optimizers.pod_sync.reset()
    records, state = _steps(build_model(_cfg(DENSE)), None, strategy, state,
                            _micro(batches, k, 0), k)
    tree = {"params": state.params, "opt": {"m": state.opt.m}}
    return {"records": records, "params": _full(state.params),
            "locals": [(p, tuple(x.shape), tuple(x.to_local().shape))
                       for p, x in sh.tree_flatten_with_path(tree)],
            "pod_bytes": optimizers.pod_sync.bytes,
            "pod_reductions": optimizers.pod_sync.reductions,
            "mesh": mesh}


def _codist_run(pods, arch, peers, batches, k):
    """``ShardMapCompressed`` of this rank's pod's peer."""
    opt_init, _ = make_optimizer("sgdm")
    params = trainable_params(params_from_jax(peers[pods.rank], device="cpu"))
    codist = _codist()
    bytes0 = pods.wire_bytes
    records, state = _steps(build_model(_cfg(arch)), codist,
                            ShardMapCompressed(codist, pods),
                            TrainState(params, opt_init(params), 0),
                            _micro(batches, k, 1), k)
    return {"records": records, "pod": pods.rank,
            "params": _full(state.params),
            "wire_bytes": pods.wire_bytes - bytes0}


def _mesh_worker(pods, inits, batches):
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    out = {"ar": {}, "codist": {}}
    for shape, k in AR_CASES:
        m = make_host_mesh(shape)
        dm = pods.mesh if shape == MESH else device_mesh(m, "cpu")
        out["ar"][(shape, k)] = _ar_run(dm, m, inits["ar"],
                                        batches[("ar", k)], k)
    for arch, k in CODIST_CASES:
        out["codist"][(arch, k)] = _codist_run(
            pods, arch, inits[arch], batches[(arch, k)], k)
    return out


@pytest.fixture(scope="module")
def shared():
    """The reference's inits (one model; 2 peers of each arch) and the
    numpy batches."""
    import jax
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model
    from repro.optim import make_optimizer as jax_make_optimizer
    from repro.train.state import init_codist_state, init_train_state
    j_init, _ = jax_make_optimizer("sgdm")
    jms, jstates, inits, batches = {}, {}, {}, {}
    for arch in ARCHS:
        jm = jax_build_model(replace(jax_get_reduced(arch), **CUT,
                                     **ARCHS[arch]))
        js = init_codist_state(jm, jax.random.key(0), N, j_init)
        stacked = jax.tree.map(np.asarray, js.params)
        jms[arch], jstates[arch] = jm, js
        inits[arch] = [jax.tree.map(lambda a, i=i: a[i], stacked)
                       for i in range(N)]
    for arch, k in CODIST_CASES:
        batches[(arch, k)] = _batches(arch, (N, B_PEER), 5, k)
    js = init_train_state(jms[DENSE], jax.random.key(1), j_init)
    jstates["ar"] = js
    inits["ar"] = jax.tree.map(np.asarray, js.params)
    for k in {k for _m, k in AR_CASES}:
        batches[("ar", k)] = _batches(DENSE, (B,), 6, k)
    return jms, jstates, inits, batches


@pytest.fixture(scope="module")
def ranks(shared):
    _jms, _js, inits, batches = shared
    before = torch.get_num_threads()
    torch.set_num_threads(8)          # 8 ranks, one intra-op thread each
    try:
        return spawn_pods(_mesh_worker, 8, (inits, batches), device="cpu",
                          timeout_s=TIMEOUT_S, mesh=make_host_mesh(MESH))
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def single(shared):
    """The port's single-device steps (the loss kernels' plain versions):
    ("ar", k) -> (records, final params) of ``AllReduce``; (arch, k) ->
    (records, final peer trees) of ``PredictionExchange``."""
    _jms, _js, inits, batches = shared
    opt_init, _ = make_optimizer("sgdm")
    out = {}
    for k in sorted({k for _m, k in AR_CASES}):
        params = trainable_params(params_from_jax(inits["ar"], device="cpu"))
        records, state = _steps(build_model(_cfg(DENSE)), None, AllReduce(),
                                TrainState(params, opt_init(params), 0),
                                _micro(batches[("ar", k)], k, 0), k)
        out[("ar", k)] = (records, tree_map(lambda x: x.detach().numpy(),
                                            state.params))
    for arch, k in CODIST_CASES:
        params = trainable_params(peer_params_from_jax(
            _stack(inits[arch]), N, device="cpu"))
        codist = _codist()
        records, state = _steps(build_model(_cfg(arch)), codist,
                                PredictionExchange(codist),
                                CodistState(params, opt_init(params), 0),
                                _micro(batches[(arch, k)], k, 1), k)
        out[(arch, k)] = (records, [tree_map(lambda x: x.detach().numpy(), p)
                                    for p in state.params])
    return out


@pytest.fixture(scope="module")
def reference(shared):
    """The reference's single-device ``jax.jit(step)``, 3 steps, each jit
    built once: ("ar", k) -> (losses, final params); (arch, k) -> (losses,
    final stacked params)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import CodistConfig as JCodistConfig
    from repro.configs import TrainConfig as JTrainConfig
    from repro.train import AllReduce as JAllReduce
    from repro.train import PredictionExchange as JPredictionExchange
    from repro.train import build_train_step as jax_build_train_step
    jms, jstates, _inits, batches = shared
    out = {}
    cases = ([("ar", k) for k in sorted({k for _m, k in AR_CASES})]
             + CODIST_CASES)
    for arch, k in cases:
        tc = JTrainConfig(**TC, microbatch=k)
        if arch == "ar":
            step = jax_build_train_step(jms[DENSE], tc, None, JAllReduce())
            lead = 0
        else:
            jcd = JCodistConfig(n_models=N)
            step = jax_build_train_step(jms[arch], tc, jcd,
                                        JPredictionExchange(jcd))
            lead = 1
        step = jax.jit(step.variants["on"])
        js, losses = jstates[arch], []
        for batch in _micro(batches[(arch, k)], k, lead):
            js, met = step(js, {n: jnp.asarray(v) for n, v in batch.items()})
            losses.append(float(met["loss"]))
        out[(arch, k)] = (losses, jax.tree.map(np.asarray, js.params))
    return out


def _stack(peers):
    """The peers' numpy trees stacked on a leading axis."""
    return {k: (_stack([p[k] for p in peers]) if isinstance(v, dict)
                else np.stack([p[k] for p in peers]))
            for k, v in peers[0].items()}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(1.0, abs(float(b)))


def _assert_trees_close(got, want, atol, what):
    g, w = (dict(sh.tree_flatten_with_path(t)) for t in (got, want))
    assert g.keys() == w.keys(), what
    for path in g:
        np.testing.assert_allclose(g[path], w[path], rtol=0, atol=atol,
                                   err_msg=f"{what} {path}")


def _ar_id(case):
    return f"{'x'.join(map(str, case[0]))}-k{case[1]}"


@pytest.mark.parametrize("case", AR_CASES, ids=_ar_id)
def test_allreduce_on_the_mesh_matches_the_single_device_step(ranks, single,
                                                              case):
    """Every rank's losses within 1e-5 relative and the model's every leaf
    within 1e-5 of the port's single-device ``AllReduce`` at the same k."""
    records, final = single[("ar", case[1])]
    for r, rank in enumerate(ranks):
        run = rank["ar"][case]
        assert len(run["records"]) == STEPS
        for mine, want in zip(run["records"], records):
            for key in ("loss", "task_loss", "accuracy"):
                assert _rel(mine[key], want[key]) <= 1e-5, (r, key)
        _assert_trees_close(run["params"], final, 1e-5, f"rank {r}")


@pytest.mark.parametrize("case", AR_CASES, ids=_ar_id)
def test_allreduce_on_the_mesh_matches_the_reference(ranks, reference, case):
    """Within 1e-4 of the reference's single-device ``jax.jit(step)`` (its
    sharded step is red on jax 0.9.0): the losses relative, every leaf
    absolute."""
    losses, final = reference[("ar", case[1])]
    for r, rank in enumerate(ranks):
        run = rank["ar"][case]
        for mine, want in zip(run["records"], losses):
            assert _rel(mine["loss"], want) <= 1e-4, (r, mine["step"])
        _assert_trees_close(run["params"], final, 1e-4,
                            f"rank {r} vs the reference")


@pytest.mark.parametrize("shape", [MESH, TP4],
                         ids=lambda m: "x".join(map(str, m)))
def test_one_model_shards_follow_the_rules(ranks, shape):
    """On every rank each parameter and moment leaf's local shard is
    ``local_shape`` of its spec under ``state_shardings(...,
    stacked=False)``: no leaf is placed over "pod"."""
    mesh = make_host_mesh(shape)
    for r, rank in enumerate(ranks):
        for path, full, local in rank["ar"][(shape, 1)]["locals"]:
            name = path.split("/", 2 if path.startswith("opt/") else 1)[-1]
            spec = sh.param_spec(name, full, mesh, scanned=sh._scanned(name))
            assert "pod" not in sh.spec_axes(spec), (path, spec)
            assert local == sh.local_shape(full, spec, mesh), (r, path)


def _codist_id(case):
    return f"{case[0]}-k{case[1]}"


@pytest.mark.parametrize("case", CODIST_CASES, ids=_codist_id)
def test_codist_on_the_mesh_matches_the_single_device_step(ranks, single,
                                                           case):
    """``ShardMapCompressed`` with microbatches, and the rwkv6 and VLM
    steps: every rank within 1e-5 of the port's single-device
    ``PredictionExchange``."""
    records, final = single[case]
    for r, rank in enumerate(ranks):
        run = rank["codist"][case]
        assert len(run["records"]) == STEPS
        for mine, want in zip(run["records"], records):
            for key in ("loss", "task_loss", "distill_loss",
                        "task_loss_per_model_0", "task_loss_per_model_1"):
                assert _rel(mine[key], want[key]) <= 1e-5, (r, key)
            assert mine["distill_loss"] > 0
        _assert_trees_close(run["params"], final[run["pod"]], 1e-5,
                            f"rank {r}")


@pytest.mark.parametrize("case", CODIST_CASES, ids=_codist_id)
def test_codist_on_the_mesh_matches_the_reference(ranks, reference, case):
    losses, stacked = reference[case]
    for r, rank in enumerate(ranks):
        run = rank["codist"][case]
        for mine, want in zip(run["records"], losses):
            assert _rel(mine["loss"], want) <= 1e-4, (r, mine["step"])
        _assert_trees_close(run["params"],
                            tree_map(lambda a, p=run["pod"]: a[p], stacked),
                            1e-4, f"rank {r} vs the reference")


def test_cross_pod_traffic_codist_vs_allreduce(ranks):
    """The port's counterpart of the reference's
    ``test_cross_pod_traffic_codist_vs_allreduce``: on (2, 2, 2) the bytes
    a device sends across pods a step, metered (the pod group's gather of
    the wire for codist, the optimizer's reduction over "pod" for the
    baseline), equal ``launch/cost.py``'s ``cross_pod_bytes`` of the same
    step; both are above 0, and codist's are below the baseline's at V 64,
    as the reference's docstring states. The none wire keeps the logits'
    placement (rows over "data", V over "model"), so every rank sends and
    meters its own shard, as the reference's all-gather over "pod" sends
    each device's."""
    mesh = make_host_mesh(MESH)
    cfg = _cfg(DENSE)
    ar_cost = step_cost(cfg, InputShape("traffic", S, B, "train"),
                        "allreduce", mesh=mesh).collectives.cross_pod_bytes
    cd_cost = step_cost(cfg, InputShape("traffic", S, N * B_PEER, "train"),
                        "codist", codist_n=N,
                        mesh=mesh).collectives.cross_pod_bytes
    ar = [rank["ar"][(MESH, 1)] for rank in ranks]
    cd = [rank["codist"][(DENSE, 1)] for rank in ranks]
    for r, run in enumerate(ar):
        assert run["pod_bytes"] == STEPS * ar_cost, (r, run["pod_bytes"])
    for r, run in enumerate(cd):
        assert run["wire_bytes"] == STEPS * cd_cost, (r, run["wire_bytes"])
    assert ar_cost > 0 and cd_cost > 0
    assert cd_cost < ar_cost, (cd_cost, ar_cost)


def test_microbatches_reduce_across_pods_once_a_step(ranks):
    """With 2 microbatches the gradient's sum over the pods is reduced
    once a step, as the cost model counts it, not once a microbatch."""
    one = [rank["ar"][(MESH, 1)] for rank in ranks]
    two = [rank["ar"][(MESH, 2)] for rank in ranks]
    for a, b in zip(one, two):
        assert b["pod_bytes"] == a["pod_bytes"] > 0
        assert b["pod_reductions"] == a["pod_reductions"]
    assert all(rank["ar"][(TP4, 1)]["pod_bytes"] == 0 for rank in ranks)
