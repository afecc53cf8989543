"""The MoE and hybrid families on a (pod, data, model) mesh: the reduced
grok-1, arctic (with its dense residual) and jamba (Mamba + dense FFN, then
attention + MoE) as codist peers (``ShardMapCompressed``, one peer a pod)
and as the all-reduce baseline's one model (``AllReduce``), with and
without expert parallelism (``moe_expert_axis="data"``), on eight gloo
ranks on the CPU, held against the single-device step of the port and of
the JAX reference from the same weights (``checkpoint/bridge.py``) and
numpy batches; with the expert all-to-all's bytes and the cross-pod bytes
each rank metered held to ``launch/cost.py``.

Each model is cut to 2 layers, d 64, d_ff 128, V 64, 2 heads of 32 and 4
experts top-2 (jamba's d_inner 128); 2 peers of 4 x 8 tokens, or one
model of 8 x 8; 3 steps of SGD-momentum at lr 1e-2. Without the expert
axis the experts follow the dense rules (d over "data", f over "model")
and every rank routes its own rows (``models/moe.py`` ``_moe_placed``);
with it each rank of a "data" group holds E / ways experts and the rows
reach them through an all-to-all of capacity buffers
(``_moe_experts``). Jamba's Mamba mixer runs on each rank's rows with its
weights whole. The batches' seeds are chosen so that every routing
decision of the single-device run is clear: the least gap between a
token's first and second, and second and third, router probabilities
exceeds ``MARGIN``, which the test asserts, so that rounding cannot flip a
choice between the runs. Eight ranks are spawned once (``spawn_pods(...,
mesh=)``, one intra-op thread each), with the loss kernels' DTensor entry
(``fused_losses=True``); the reference is imported in the test process
only, and each of its jits is built once.
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
from repro_torch.launch.mesh import (device_mesh, expert_exchange,
                                     make_host_mesh, mesh_pod_group,
                                     spawn_pods)
from repro_torch.models import build_model, moe
from repro_torch.optim import make_optimizer, optimizers
from repro_torch.train import (AllReduce, History, PredictionExchange,
                               ShardMapCompressed, build_train_step)
from repro_torch.train.state import CodistState, TrainState, trainable_params
from repro_torch.tree import tree_map

CUT = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64, num_heads=2,
           num_kv_heads=2, head_dim=32)
GROK, ARCTIC, JAMBA = "grok-1-314b", "arctic-480b", "jamba-v0.1-52b"
ARCHS = (GROK, ARCTIC, JAMBA)
N, B_PEER, S, STEPS = 2, 4, 8, 3
TC = dict(lr=1e-2, total_steps=10, warmup_steps=0, optimizer="sgdm")
MESH, TP4, DP4 = (2, 2, 2), (2, 1, 4), (2, 4, 1)
EP = "data"
# (arch, strategy, mesh, expert axis, microbatches)
CASES = [(GROK, "codist", MESH, None, 1), (GROK, "codist", MESH, EP, 1),
         (GROK, "codist", TP4, None, 1), (GROK, "codist", DP4, EP, 1),
         (GROK, "allreduce", MESH, None, 1), (GROK, "allreduce", MESH, EP, 1),
         (ARCTIC, "codist", MESH, None, 1), (ARCTIC, "codist", MESH, EP, 1),
         (ARCTIC, "codist", DP4, EP, 1), (ARCTIC, "codist", MESH, EP, 2),
         (ARCTIC, "allreduce", MESH, EP, 1),
         (JAMBA, "codist", MESH, None, 1), (JAMBA, "codist", MESH, EP, 1),
         (JAMBA, "codist", TP4, None, 1), (JAMBA, "allreduce", MESH, None, 1),
         (JAMBA, "allreduce", MESH, EP, 1)]
# the least router margin of the single-device runs, and the batches' seed
# of each (arch, strategy, microbatches), chosen so that its run's margin
# exceeds it
MARGIN = 1e-3
SEEDS = {(GROK, "codist", 1): 20, (GROK, "allreduce", 1): 17,
         (ARCTIC, "codist", 1): 71, (ARCTIC, "codist", 2): 2045,
         (ARCTIC, "allreduce", 1): 65,
         (JAMBA, "codist", 1): 4, (JAMBA, "allreduce", 1): 1}
# remat with the backward on another thread (jamba: the attention core's
# placements come from the hints' context)
REMAT_CASE = (JAMBA, "codist", MESH, EP, 1)
TIMEOUT_S = 900.0


def _cfg(arch):
    return replace(get_reduced(arch), **CUT)


def _batches(lead, seed, k=1):
    """``STEPS`` numpy batches of ``lead`` rows, k times as many in the
    last lead dim for k microbatches."""
    lead = (*lead[:-1], k * lead[-1])
    rng = np.random.default_rng(seed)
    v = CUT["vocab_size"]
    return [{"tokens": rng.integers(0, v, (*lead, S)).astype(np.int32),
             "labels": rng.integers(0, v, (*lead, S)).astype(np.int32),
             "mask": (rng.random((*lead, S)) > 0.2).astype(np.float32)}
            for _ in range(STEPS)]


def _micro(batches, k, lead_axes):
    """Each leaf's batch dim (after ``lead_axes`` leading axes) split into
    (k, B/k): the engine's microbatched layout."""
    if k == 1:
        return batches

    def one(v):
        a = lead_axes
        return v.reshape(*v.shape[:a], k, v.shape[a] // k, *v.shape[a + 1:])
    return [{n: one(v) for n, v in b.items()} for b in batches]


def _data(arch, mode, k):
    """The step's batches: 2 peers' (n, [k,] B, S) or one model's ([k,]
    2 B, S)."""
    seed = SEEDS[(arch, mode, k)]
    if mode == "codist":
        return _micro(_batches((N, B_PEER), seed, k), k, 1)
    return _micro(_batches((N * B_PEER,), seed, k), k, 0)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _steps(model, codist, strategy, state, batches, k, remat=False):
    tc = TrainConfig(**TC, fused_losses=True, microbatch=k, remat=remat)
    bundle = build_train_step(model, tc, codist, strategy)
    state = strategy.ensure_state(state, model, tc)
    hist = History()
    for step, batch in enumerate(batches):
        state, met, _plan = bundle.apply(state, _torch_batch(batch), step)
        hist.log(step, met)
    return hist.records, state


def _run(g, case, inits, remat=False):
    """One case on this rank's group ``g`` (with ``remat``, each layer
    recomputed in the backward): its records, full parameters, local
    shards and the meters' counts."""
    arch, mode, _shape, ep, k = case
    opt_init, _ = make_optimizer("sgdm")
    expert_exchange.reset()
    optimizers.pod_sync.reset()
    if mode == "codist":
        codist = CodistConfig(n_models=N)
        params = trainable_params(params_from_jax(inits[arch][g.rank],
                                                  device="cpu"))
        strategy = ShardMapCompressed(codist, g, moe_expert_axis=ep)
        state = TrainState(params, opt_init(params), 0)
    else:
        codist = None
        strategy = AllReduce(mesh=g, moe_expert_axis=ep)
        state = strategy.ensure_state(TrainState(trainable_params(
            params_from_jax(inits[arch][0], device="cpu")),
            optimizers.OptState(0, None, None), 0), None, None)
        state = state._replace(opt=opt_init(state.params))
    wire0 = g.wire_bytes
    records, state = _steps(build_model(_cfg(arch)), codist, strategy, state,
                            _data(arch, mode, k), k, remat)
    return {"records": records, "pod": g.rank,
            "params": tree_map(lambda x: x.full_tensor().detach().numpy(),
                               state.params),
            "locals": [(p, tuple(x.shape), tuple(x.to_local().shape))
                       for p, x in sh.tree_flatten_with_path(state.params)],
            "a2a_bytes": expert_exchange.bytes,
            "a2a": expert_exchange.exchanges,
            "wire_bytes": g.wire_bytes - wire0,
            "pod_bytes": optimizers.pod_sync.bytes}


def _mesh_worker(pods, inits):
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    groups = {MESH: pods}
    out = {}
    for case in CASES:
        shape = case[2]
        if shape not in groups:
            m = make_host_mesh(shape)
            groups[shape] = mesh_pod_group(m, device_mesh(m, "cpu"),
                                           pods.device)
        out[case] = _run(groups[shape], case, inits)
    out["remat"] = _remat_on_another_thread(groups[REMAT_CASE[2]], inits)
    return out


def _remat_on_another_thread(g, inits):
    """REMAT_CASE with each layer recomputed in the backward, the backward
    run on another thread, as a CUDA backward runs on the autograd
    engine's device thread: the recomputation must see the forward's
    placements there (``sharding_hints.remat_context``). DTensor's
    implicit replication is set on that thread, as torch 2.11's global
    flag is on the card (torch 2.13's is the thread's own)."""
    import threading
    from torch.distributed.tensor import DTensor
    real = torch.autograd.grad

    def on_another_thread(*args, **kw):
        out = {}

        def run():
            DTensor._op_dispatcher._allow_implicit_replication = True
            try:
                out["grads"] = real(*args, **kw)
            except BaseException as e:       # raised on the caller's thread
                out["error"] = e
        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "error" in out:
            raise out["error"]
        return out["grads"]
    torch.autograd.grad = on_another_thread
    try:
        return _run(g, REMAT_CASE, inits, remat=True)
    finally:
        torch.autograd.grad = real


def _jax_cfg(arch):
    from repro.configs import get_reduced as jax_get_reduced
    return replace(jax_get_reduced(arch), **CUT)


@pytest.fixture(scope="module")
def shared():
    """The reference's models and its codist states' inits: 2 peers a
    arch, as numpy trees (the baseline's one model is peer 0)."""
    import jax
    from repro.models import build_model as jax_build_model
    from repro.optim import make_optimizer as jax_make_optimizer
    from repro.train.state import init_codist_state
    j_init, _ = jax_make_optimizer("sgdm")
    jms, jstates, inits = {}, {}, {}
    for arch in ARCHS:
        jm = jax_build_model(_jax_cfg(arch))
        js = jax.jit(lambda key, jm=jm: init_codist_state(jm, key, N, j_init)
                     )(jax.random.key(0))
        stacked = jax.tree.map(np.asarray, js.params)
        jms[arch], jstates[arch] = jm, js
        inits[arch] = [jax.tree.map(lambda a, i=i: a[i], stacked)
                       for i in range(N)]
    return jms, jstates, inits


@pytest.fixture(scope="module")
def ranks(shared):
    _jms, _js, inits = shared
    before = torch.get_num_threads()
    torch.set_num_threads(8)          # 8 ranks, one intra-op thread each
    try:
        res = spawn_pods(_mesh_worker, 8, (inits,), device="cpu",
                         timeout_s=TIMEOUT_S, mesh=make_host_mesh(MESH))
    finally:
        torch.set_num_threads(before)
    return res


def _single_keys():
    return sorted({(a, m, k) for a, m, _s, _e, k in CASES})


@pytest.fixture(scope="module")
def single(shared, monkeypatch_module):
    """The port's single-device steps: (arch, strategy, k) -> (records,
    final params: the peer list's or the one model's, the least router
    margin over every routing of the run)."""
    _jms, _js, inits = shared
    margins = []
    route = moe._route

    def recording(m, logits, capacity):
        probs = torch.sort(torch.softmax(logits.detach(), -1), -1,
                           descending=True).values
        margins.append(float(torch.minimum(
            probs[..., 0] - probs[..., 1], probs[..., 1] - probs[..., 2])
            .min()))
        return route(m, logits, capacity)
    monkeypatch_module.setattr(moe, "_route", recording)
    opt_init, _ = make_optimizer("sgdm")
    out = {}
    for arch, mode, k in _single_keys():
        margins.clear()
        model = build_model(_cfg(arch))
        if mode == "codist":
            codist = CodistConfig(n_models=N)
            params = trainable_params(peer_params_from_jax(
                _stack(inits[arch]), N, device="cpu"))
            records, state = _steps(model, codist, PredictionExchange(codist),
                                    CodistState(params, opt_init(params), 0),
                                    _data(arch, mode, k), k)
            final = [tree_map(lambda x: x.detach().numpy(), p)
                     for p in state.params]
        else:
            params = trainable_params(params_from_jax(inits[arch][0],
                                                      device="cpu"))
            records, state = _steps(model, None, AllReduce(),
                                    TrainState(params, opt_init(params), 0),
                                    _data(arch, mode, k), k)
            final = tree_map(lambda x: x.detach().numpy(), state.params)
        out[(arch, mode, k)] = (records, final, min(margins))
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def reference(shared):
    """The reference's single-device ``jax.jit(step)``, 3 steps, each jit
    built once: (arch, strategy, k) -> (losses, aux losses, final params:
    stacked for codist)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import CodistConfig as JCodistConfig
    from repro.configs import TrainConfig as JTrainConfig
    from repro.optim import make_optimizer as jax_make_optimizer
    from repro.train import AllReduce as JAllReduce
    from repro.train import PredictionExchange as JPredictionExchange
    from repro.train import build_train_step as jax_build_train_step
    from repro.train.state import TrainState as JTrainState
    jms, jstates, _inits = shared
    j_init, _ = jax_make_optimizer("sgdm")
    out = {}
    for arch, mode, k in _single_keys():
        tc = JTrainConfig(**TC, microbatch=k)
        js = jstates[arch]
        if mode == "codist":
            jcd = JCodistConfig(n_models=N)
            step = jax_build_train_step(jms[arch], tc, jcd,
                                        JPredictionExchange(jcd))
        else:
            step = jax_build_train_step(jms[arch], tc, None, JAllReduce())
            p0 = jax.tree.map(lambda a: a[0], js.params)
            js = JTrainState(p0, j_init(p0), 0)
        step = jax.jit(step.variants["on"])
        losses, auxs = [], []
        for batch in _data(arch, mode, k):
            js, met = step(js, {n: jnp.asarray(v) for n, v in batch.items()})
            losses.append(float(met["loss"]))
            auxs.append(float(met["aux_loss"]))
        out[(arch, mode, k)] = (losses, auxs,
                                jax.tree.map(np.asarray, js.params))
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


def _total(record, mode):
    """A single-device record's loss with its aux term: ``PredictionExchange``
    logs the codist loss without it, ``ShardMapCompressed`` and
    ``AllReduce`` with it (the reference's metrics alike)."""
    if mode == "codist":
        return record["loss"] + record["aux_loss"]
    return record["loss"]


def _id(case):
    arch, mode, shape, ep, k = case
    return (f"{arch.split('-')[0]}-{mode}-{'x'.join(map(str, shape))}"
            f"-{'ep' if ep else 'fsdp'}-k{k}")


def test_remat_recomputes_under_the_forwards_hints():
    """``remat_context``'s recomputation context gives a thread without the
    hint context (a CUDA backward's device thread) the forward's, and
    leaves that thread's own as it was; the forward's context is a no-op."""
    import threading
    from repro_torch.models import sharding_hints as shh
    shape = (4, 8, 2, 64, 64)
    with shh.activation_sharding(("data",), "model", 2):
        want = shh.current_hint_spec("scores", shape[1:])
        fwd, rec = shh.remat_context()
        with fwd:
            assert shh.current_hint_spec("scores", shape[1:]) == want
    assert want is not None
    seen = []

    def backward_thread():
        seen.append(shh.current_hint_spec("scores", shape[1:]))
        with rec:
            seen.append(shh.current_hint_spec("scores", shape[1:]))
        seen.append(shh.current_hint_spec("scores", shape[1:]))
    t = threading.Thread(target=backward_thread)
    t.start()
    t.join()
    assert seen == [None, want, None]


def test_router_margins_are_clear(single):
    """Every routing of the single-device runs has a top-2 choice apart
    from its neighbours by more than MARGIN."""
    for key, (_r, _f, margin) in single.items():
        assert margin > MARGIN, (key, margin)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_moe_on_the_mesh_matches_the_single_device_step(ranks, single, case):
    """Every rank's losses (task, distillation, aux, the total) within
    1e-5 relative and its model's every leaf within 1e-5 of the port's
    single-device step (``PredictionExchange`` over both peers, or
    ``AllReduce``) from the same weights and batches."""
    arch, mode, _shape, _ep, k = case
    records, final, _margin = single[(arch, mode, k)]
    keys = ("task_loss", "aux_loss") + (
        ("distill_loss",) if mode == "codist" else ())
    for r, rank in enumerate(ranks):
        run = rank[case]
        assert len(run["records"]) == STEPS
        for mine, want in zip(run["records"], records):
            for key in keys:
                assert _rel(mine[key], want[key]) <= 1e-5, (r, key)
            assert _rel(mine["loss"], _total(want, mode)) <= 1e-5, r
            assert mine["aux_loss"] > 0
        want = final[run["pod"]] if mode == "codist" else final
        _assert_trees_close(run["params"], want, 1e-5, f"rank {r}")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_moe_on_the_mesh_matches_the_reference(ranks, reference, case):
    """Within 1e-4 of the reference's single-device ``jax.jit(step)``: the
    losses relative, every leaf absolute."""
    arch, mode, _shape, _ep, k = case
    losses, auxs, final = reference[(arch, mode, k)]
    for r, rank in enumerate(ranks):
        run = rank[case]
        for mine, loss, aux in zip(run["records"], losses, auxs):
            want = loss + aux if mode == "codist" else loss
            assert _rel(mine["loss"], want) <= 1e-4, (r, mine["step"])
            assert _rel(mine["aux_loss"], aux) <= 1e-4, (r, mine["step"])
        want = (tree_map(lambda a, p=run["pod"]: a[p], final)
                if mode == "codist" else final)
        _assert_trees_close(run["params"], want, 1e-4,
                            f"rank {r} vs the reference")


@pytest.mark.parametrize("case", [c for c in CASES if c[3]], ids=_id)
def test_expert_stacks_stay_split_over_the_expert_axis(ranks, case):
    """With the expert axis every expert stack's local shard holds E / ways
    experts, whole in d, f over "model" (``param_spec(...,
    moe_expert_axis=)``), and no rank gathers them; without it no
    all-to-all runs."""
    arch, mode, shape, ep, _k = case
    mesh = make_host_mesh(shape)
    cfg = _cfg(arch)
    e = cfg.moe.num_experts
    for r, rank in enumerate(ranks):
        for path, full, local in rank[case]["locals"]:
            if path.endswith(("ffn/w_gate", "ffn/w_up", "ffn/w_down")) \
                    and len(full) == 4:
                assert local[1] == e // mesh.shape[ep], (r, path, local)
                spec = sh.param_spec(path, full, mesh, scanned=True,
                                     moe_expert_axis=ep)
                assert local == sh.local_shape(full, spec, mesh), (r, path)
        assert rank[case]["a2a"] > 0
    for c in CASES:
        if not c[3]:
            assert all(rank[c]["a2a"] == 0 for rank in ranks), c


def test_remat_on_the_mesh_with_the_backward_on_another_thread(ranks,
                                                             single):
    """REMAT_CASE recomputed in a backward on another thread: every rank's
    losses and leaves within 1e-5 of the single-device step (which remat
    does not change), and each all-to-all run a third time, in the
    recomputed forward."""
    arch, mode, _shape, _ep, k = REMAT_CASE
    records, final, _margin = single[(arch, mode, k)]
    n_moe = sum(_cfg(arch).is_moe_layer(i) for i in range(CUT["num_layers"]))
    for r, rank in enumerate(ranks):
        run = rank["remat"]
        for mine, want in zip(run["records"], records):
            assert _rel(mine["loss"], _total(want, mode)) <= 1e-5, r
            assert _rel(mine["distill_loss"], want["distill_loss"]) <= 1e-5
        _assert_trees_close(run["params"], final[run["pod"]], 1e-5,
                            f"rank {r}")
        assert run["a2a"] == STEPS * 6 * n_moe == 1.5 * rank[REMAT_CASE][
            "a2a"], (r, run["a2a"])


def _cost(case):
    arch, mode, shape, ep, k = case
    rows = N * B_PEER * k
    return step_cost(_cfg(arch), InputShape("moe", S, rows, "train"),
                     mode, codist_n=N, remat=False, microbatch=k,
                     mesh=make_host_mesh(shape),
                     variant={"moe_expert_axis": ep},
                     codist_extra={"compression": "none"}).collectives


@pytest.mark.parametrize("case", [c for c in CASES if c[3]], ids=_id)
def test_expert_and_cross_pod_traffic_equal_the_cost_model(ranks, case):
    """The traffic test: every rank's metered all-to-all bytes (its
    capacity buffers, forward and backward) and cross-pod bytes (the
    codist wire's gather, or the baseline's gradient reduction over
    "pod") equal ``launch/cost.py``'s ``step_cost`` of the same step, 3
    steps of it."""
    ops = _cost(case)
    a2a = sum(o.operand_bytes for o in ops.ops if o.kind == "all-to-all")
    n_a2a = sum(o.kind == "all-to-all" for o in ops.ops)
    assert a2a > 0 and ops.cross_pod_bytes > 0
    for r, rank in enumerate(ranks):
        run = rank[case]
        assert run["a2a_bytes"] == STEPS * a2a, (r, run["a2a_bytes"], a2a)
        assert run["a2a"] == STEPS * n_a2a, (r, run["a2a"], n_a2a)
        metered = run["wire_bytes"] if case[1] == "codist" else \
            run["pod_bytes"]
        assert metered == STEPS * ops.cross_pod_bytes, (r, metered)
