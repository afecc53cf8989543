"""The paper's own models on a (pod, data, model) mesh: the enc-dec LMs
(transformer-big over source tokens and over frames, whisper-tiny) and the
classifiers (resnet50, wrn28x10, the MLP) as codist peers
(``ShardMapCompressed``, one peer a pod) and as the all-reduce baseline's
one model (``AllReduce``), on eight gloo ranks on the CPU, held against the
single-device step of the port and of the JAX reference from the same
weights (``checkpoint/bridge.py``) and numpy batches; with the cross-pod
traffic of both strategies held to ``launch/cost.py``, each strategy's
eval, and both resnet50 peers on one pod's devices (``PredictionExchange``
over a placed peer list) exchanging every other step.

The enc-dec models are the reduced configs cut to 2 + 2 layers, d 64, d_ff
128, V 64: transformer-big at 2 heads of 32 (which do not divide the
4-way TP of (2, 1, 4), so its projections run on local rows), whisper-tiny
at 4 heads of 16 (which do: its attention cores, cross-attention's too,
run on split heads there), 16 and 24 numpy frames; 2 peers of 4 x 8
tokens, or one model of 8 x 8. The encoder's self-attention and the
decoder's cross-attention run on each rank's rows and heads through
``local_map``; transformer-big over frames checkpoints its decoder layers
(``remat``). The conv nets are the reduced resnet50 (its stem and stage 0
frozen by ``freeze_mask``) and wrn28x10 over 32 x 32 images, placed whole
on every rank (the rules replicate them), the forward on each rank's own
rows (``models/conv.py`` ``_forward_placed``: no group norm runs on a
DTensor); the MLP (64 -> 32 -> 32 -> 10) runs through DTensor's own
dispatch. Every run takes 3 steps of SGD-momentum at lr 1e-2 with the loss
kernels' DTensor entry (``fused_losses=True``: their plain versions inside
``local_map``) on (B, S, V) rows and on a classifier's (B, classes) rows.
Eight ranks are spawned once (``spawn_pods(..., mesh=)``, one intra-op
thread each); the reference is imported in the test process only, and
each of its jits is built once.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (params_from_jax, params_to_numpy,
                                   peer_params_from_jax)
from repro_torch.configs import CodistConfig, TrainConfig, get_config, \
    get_reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import sharding as sh
from repro_torch.launch.cost import step_cost
from repro_torch.launch.mesh import (device_mesh, make_host_mesh,
                                     mesh_pod_group, spawn_pods)
from repro_torch.models import build_model
from repro_torch.models.conv import freeze_mask
from repro_torch.models.mlp import MLP, MLPConfig
from repro_torch.optim import make_optimizer, optimizers
from repro_torch.train import (AllReduce, History, PredictionExchange,
                               ShardMapCompressed, build_train_step)
from repro_torch.train.state import CodistState, TrainState, trainable_params
from repro_torch.tree import tree_map

ENC = dict(num_layers=2, encoder_layers=2, d_model=64, d_ff=128,
           vocab_size=64)
MLP_DIMS = dict(in_dim=64, hidden=(32, 32), num_classes=10)
# name -> (arch, overrides of its reduced config); the MLP has no arch
MODELS = {
    "tbig-src": ("transformer-big", dict(ENC, num_heads=2, num_kv_heads=2,
                                         head_dim=32, num_audio_frames=0)),
    "tbig-frames": ("transformer-big", dict(ENC, num_heads=2, num_kv_heads=2,
                                            head_dim=32,
                                            num_audio_frames=16)),
    "whisper": ("whisper-tiny", dict(ENC, num_heads=4, num_kv_heads=4,
                                     head_dim=16, num_audio_frames=24)),
    "resnet50": ("resnet50", {}),
    "wrn28x10": ("wrn28x10", {}),
    "mlp": (None, MLP_DIMS),
}
FROZEN = {"resnet50": ("stem", "s0")}     # freeze_mask's prefixes
REMAT = ("tbig-frames",)
N, B_PEER, B, S, STEPS = 2, 4, 8, 8, 3
TC = dict(lr=1e-2, total_steps=10, warmup_steps=0, optimizer="sgdm")
MESH = (2, 2, 2)
TP4 = (2, 1, 4)
CODIST_CASES = [("tbig-src", MESH), ("tbig-src", TP4),
                ("tbig-frames", MESH), ("tbig-frames", TP4),
                ("whisper", MESH), ("whisper", TP4),
                ("resnet50", MESH), ("wrn28x10", MESH), ("mlp", MESH)]
AR_CASES = ["tbig-src", "resnet50", "wrn28x10"]
# both peers on one pod's devices, exchanging every other step
ONE_POD, ONE_POD_CASE = (1, 2, 4), "resnet50"
ENCDEC = ("tbig-src", "tbig-frames", "whisper")
EVAL_KEYS = ("eval_loss", "eval_accuracy")
TIMEOUT_S = 900.0


def _cfg(name):
    arch, kw = MODELS[name]
    if arch is None:
        return MLPConfig(**kw)
    return replace(get_reduced(arch), **kw)


def _model(name):
    cfg = _cfg(name)
    return MLP(cfg) if name == "mlp" else build_model(cfg)


def _batches(name, lead, seed):
    """``STEPS`` numpy batches of ``lead`` rows: tokens, labels and a mask
    with source tokens or frames (enc-dec), images or features and one
    label a row (the classifiers)."""
    cfg = _cfg(name)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        if name not in ENCDEC:
            if name == "mlp":
                x = {"features": rng.standard_normal(
                    (*lead, cfg.in_dim)).astype(np.float32)}
            else:
                size = cfg.image_size
                x = {"images": rng.standard_normal(
                    (*lead, size, size, 3)).astype(np.float32)}
            x["labels"] = rng.integers(0, cfg.num_classes,
                                       lead).astype(np.int32)
            out.append(x)
            continue
        v = ENC["vocab_size"]
        b = {"tokens": rng.integers(0, v, (*lead, S)).astype(np.int32),
             "labels": rng.integers(0, v, (*lead, S)).astype(np.int32),
             "mask": (rng.random((*lead, S)) > 0.2).astype(np.float32)}
        if cfg.num_audio_frames:
            b["frames"] = (0.5 * rng.standard_normal(
                (*lead, cfg.num_audio_frames, cfg.d_model))).astype(
                    np.float32)
        else:
            b["src_tokens"] = rng.integers(0, v, (*lead, S)).astype(np.int32)
        out.append(b)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _full(tree):
    return tree_map(lambda x: x.full_tensor().detach().numpy(), tree)


def _locals(state):
    """(path, global shape, local shape) of every parameter and moment."""
    tree = {"params": state.params, "opt": {"m": state.opt.m}}
    return [(p, tuple(x.shape), tuple(x.to_local().shape))
            for p, x in sh.tree_flatten_with_path(tree)]


def _trainable(name, params):
    return freeze_mask(params, FROZEN[name]) if name in FROZEN else None


def _steps(name, codist, strategy, state, batches):
    """``STEPS`` steps: (History records, final state, the strategy's
    eval of the final parameters on the first batch)."""
    tc = TrainConfig(**TC, fused_losses=True, remat=name in REMAT)
    model = _model(name)
    state = strategy.ensure_state(state, model, tc)
    one = state.params[0] if isinstance(state.params, list) else state.params
    bundle = build_train_step(model, tc, codist, strategy,
                              _trainable(name, one))
    hist = History()
    for step, batch in enumerate(batches):
        state, met, _plan = bundle.apply(state, _torch_batch(batch), step)
        hist.log(step, met)
    ev = bundle.eval_fn(state.params, _torch_batch(batches[0]))
    return hist.records, state, {k: float(ev[k]) for k in EVAL_KEYS}


def _ar_run(pods, name, params, batches):
    """``AllReduce`` over every rank: its records, full parameters, local
    shard shapes and the cross-pod bytes it metered."""
    opt_init, _ = make_optimizer("sgdm")
    strategy = AllReduce(mesh=pods)
    state = strategy.ensure_state(
        TrainState(trainable_params(params_from_jax(params, device="cpu")),
                   optimizers.OptState(0, None, None), 0), None, None)
    state = state._replace(opt=opt_init(state.params))
    optimizers.pod_sync.reset()
    records, state, ev = _steps(name, None, strategy, state, batches)
    return {"records": records, "params": _full(state.params), "eval": ev,
            "locals": _locals(state), "pod_bytes": optimizers.pod_sync.bytes}


def _codist_run(pods, name, peers, batches):
    """``ShardMapCompressed`` of this rank's pod's peer."""
    opt_init, _ = make_optimizer("sgdm")
    params = trainable_params(params_from_jax(peers[pods.rank], device="cpu"))
    codist = CodistConfig(n_models=N)
    bytes0 = pods.wire_bytes
    records, state, ev = _steps(name, codist,
                                ShardMapCompressed(codist, pods),
                                TrainState(params, opt_init(params), 0),
                                batches)
    return {"records": records, "pod": pods.rank, "eval": ev,
            "params": _full(state.params), "locals": _locals(state),
            "wire_bytes": pods.wire_bytes - bytes0,
            "coordinate": pods.mesh.get_coordinate()}


class _OnePod(PredictionExchange):
    """``PredictionExchange`` over both peers placed on one pod's ("data",
    "model") devices (``distribute_state`` of the peer list, the peer axis
    unplaced) and its batches placed there too."""

    def __init__(self, codist, mesh, sub_mesh):
        super().__init__(codist)
        self.logical, self.sub_mesh = mesh, sub_mesh

    def ensure_state(self, state, model, tc, example_batch=None):
        return sh.distribute_state(state, self.logical, self.sub_mesh, N)

    def prepare(self, state, batch_all, k):
        return super().prepare(state, sh.distribute_batch(
            batch_all, self.logical, self.sub_mesh), k)


def _one_pod_run(dm, name, peers, batches):
    """``_OnePod`` over a period of 2 (the second step runs the task-only
    variant, ``_plain_task_metrics`` over a classifier's rows)."""
    opt_init, _ = make_optimizer("sgdm")
    params = trainable_params(peer_params_from_jax(_stack(peers), N,
                                                   device="cpu"))
    codist = CodistConfig(n_models=N, period=2)
    tc = TrainConfig(**TC, fused_losses=True)
    strategy = _OnePod(codist, make_host_mesh(ONE_POD), dm["data", "model"])
    state = strategy.ensure_state(CodistState(params, opt_init(params), 0),
                                  None, tc)
    bundle = build_train_step(_model(name), tc, codist, strategy,
                              _trainable(name, params[0]))
    hist = History()
    for step, batch in enumerate(batches):
        state, met, _plan = bundle.apply(state, _torch_batch(batch), step)
        hist.log(step, met)
    return {"records": hist.records,
            "params": [_full(p) for p in state.params]}


def _mesh_worker(pods, inits, batches):
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    groups = {MESH: pods}
    m = make_host_mesh(TP4)
    groups[TP4] = mesh_pod_group(m, device_mesh(m, "cpu"), "cpu")
    out = {"ar": {}, "codist": {}}
    for name in AR_CASES:
        out["ar"][name] = _ar_run(pods, name, inits[("ar", name)],
                                  batches[("ar", name)])
    for name, shape in CODIST_CASES:
        out["codist"][(name, shape)] = _codist_run(
            groups[shape], name, inits[name], batches[name])
    out["one_pod"] = _one_pod_run(device_mesh(make_host_mesh(ONE_POD), "cpu"),
                                  ONE_POD_CASE, inits[ONE_POD_CASE],
                                  batches[ONE_POD_CASE])
    return out


def _jax_model(name):
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model
    from repro.models.mlp import MLP as JMLP
    from repro.models.mlp import MLPConfig as JMLPConfig
    arch, kw = MODELS[name]
    if arch is None:
        return JMLP(JMLPConfig(**kw))
    return jax_build_model(replace(jax_get_reduced(arch), **kw))


@pytest.fixture(scope="module")
def shared():
    """The inits as numpy trees in the reference's layout (2 peers of each
    model, one model of each all-reduce case; the port's draw from a
    seed, handed to both sides) and the numpy batches."""
    inits, batches = {}, {}
    for i, name in enumerate(MODELS):
        gen = torch.Generator().manual_seed(i)
        inits[name] = [params_to_numpy(_model(name).init(gen, device="cpu"))
                       for _ in range(N)]
        batches[name] = _batches(name, (N, B_PEER), 10 + i)
    for i, name in enumerate(AR_CASES):
        gen = torch.Generator().manual_seed(20 + i)
        inits[("ar", name)] = params_to_numpy(_model(name).init(
            gen, device="cpu"))
        batches[("ar", name)] = _batches(name, (B,), 30 + i)
    return inits, batches


@pytest.fixture(scope="module")
def ranks(shared):
    inits, batches = shared
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
    ("ar", name) -> (records, final params, eval) of ``AllReduce``; name ->
    (records, final peer trees, eval) of ``PredictionExchange``; "one_pod"
    -> (records, final peer trees) of it at a period of 2."""
    inits, batches = shared
    opt_init, _ = make_optimizer("sgdm")
    out = {}
    for name in AR_CASES:
        params = trainable_params(params_from_jax(inits[("ar", name)],
                                                  device="cpu"))
        records, state, ev = _steps(name, None, AllReduce(),
                                    TrainState(params, opt_init(params), 0),
                                    batches[("ar", name)])
        out[("ar", name)] = (records, tree_map(lambda x: x.detach().numpy(),
                                               state.params), ev)
    for name in MODELS:
        params = trainable_params(peer_params_from_jax(
            _stack(inits[name]), N, device="cpu"))
        codist = CodistConfig(n_models=N)
        records, state, ev = _steps(name, codist,
                                    PredictionExchange(codist),
                                    CodistState(params, opt_init(params), 0),
                                    batches[name])
        out[name] = (records, [tree_map(lambda x: x.detach().numpy(), p)
                               for p in state.params], ev)
    params = trainable_params(peer_params_from_jax(
        _stack(inits[ONE_POD_CASE]), N, device="cpu"))
    codist = CodistConfig(n_models=N, period=2)
    records, state, _ev = _steps(ONE_POD_CASE, codist,
                                 PredictionExchange(codist),
                                 CodistState(params, opt_init(params), 0),
                                 batches[ONE_POD_CASE])
    out["one_pod"] = (records, [tree_map(lambda x: x.detach().numpy(), p)
                                for p in state.params])
    return out


@pytest.fixture(scope="module")
def reference(shared):
    """The reference's single-device ``jax.jit(step)``, 3 steps, each jit
    built once: ("ar", name) -> (losses, final params); name -> (losses,
    final stacked params)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import CodistConfig as JCodistConfig
    from repro.configs import TrainConfig as JTrainConfig
    from repro.models.conv import freeze_mask as jax_freeze_mask
    from repro.optim import make_optimizer as jax_make_optimizer
    from repro.train import AllReduce as JAllReduce
    from repro.train import PredictionExchange as JPredictionExchange
    from repro.train import build_train_step as jax_build_train_step
    from repro.train.state import CodistState as JCodistState
    from repro.train.state import TrainState as JTrainState
    inits, batches = shared
    j_init, _ = jax_make_optimizer("sgdm")
    out = {}
    for key in [("ar", n) for n in AR_CASES] + list(MODELS):
        one_model = isinstance(key, tuple)
        name = key[1] if one_model else key
        params = jax.tree.map(jnp.asarray, inits[key] if one_model
                              else _stack(inits[key]))
        zero = jnp.zeros((), jnp.int32)
        js = (JTrainState(params, j_init(params), zero) if one_model
              else JCodistState(params, j_init(params), zero))
        one = inits[key] if one_model else inits[key][0]
        trainable = (jax_freeze_mask(one, FROZEN[name]) if name in FROZEN
                     else None)
        jm = _jax_model(name)
        tc = JTrainConfig(**TC)
        if one_model:
            step = jax_build_train_step(jm, tc, None, JAllReduce(), trainable)
        else:
            jcd = JCodistConfig(n_models=N)
            step = jax_build_train_step(jm, tc, jcd, JPredictionExchange(jcd),
                                        trainable)
        step = jax.jit(step.variants["on"])
        losses = []
        for batch in batches[key]:
            js, met = step(js, {n: jnp.asarray(v) for n, v in batch.items()})
            losses.append(float(met["loss"]))
        out[key] = (losses, jax.tree.map(np.asarray, js.params))
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


def _codist_id(case):
    return f"{case[0]}-{'x'.join(map(str, case[1]))}"


@pytest.mark.parametrize("case", CODIST_CASES, ids=_codist_id)
def test_codist_on_the_mesh_matches_the_single_device_step(ranks, single,
                                                           case):
    """Every rank within 1e-5 of the port's single-device
    ``PredictionExchange``: the losses relative, its pod's peer's every
    leaf absolute (a frozen leaf too)."""
    records, final, _ev = single[case[0]]
    for r, rank in enumerate(ranks):
        run = rank["codist"][case]
        assert len(run["records"]) == STEPS
        for mine, want in zip(run["records"], records):
            for key in ("loss", "task_loss", "distill_loss", "accuracy",
                        "task_loss_per_model_0", "task_loss_per_model_1"):
                assert _rel(mine[key], want[key]) <= 1e-5, (r, key)
            assert mine["distill_loss"] > 0
        _assert_trees_close(run["params"], final[run["pod"]], 1e-5,
                            f"rank {r}")


@pytest.mark.parametrize("case", CODIST_CASES, ids=_codist_id)
def test_codist_on_the_mesh_matches_the_reference(ranks, reference, case):
    """Within 1e-4 of the reference's single-device ``jax.jit(step)`` (its
    sharded step is red on jax 0.9.0): the losses relative, every leaf
    absolute."""
    losses, stacked = reference[case[0]]
    for r, rank in enumerate(ranks):
        run = rank["codist"][case]
        for mine, want in zip(run["records"], losses):
            assert _rel(mine["loss"], want) <= 1e-4, (r, mine["step"])
        _assert_trees_close(run["params"],
                            tree_map(lambda a, p=run["pod"]: a[p], stacked),
                            1e-4, f"rank {r} vs the reference")


@pytest.mark.parametrize("name", AR_CASES)
def test_allreduce_on_the_mesh_matches_the_single_device_step(ranks, single,
                                                              name):
    """One model over every rank (rows over pod x data): losses within
    1e-5 relative and every leaf within 1e-5 of the port's single-device
    ``AllReduce``."""
    records, final, _ev = single[("ar", name)]
    for r, rank in enumerate(ranks):
        run = rank["ar"][name]
        assert len(run["records"]) == STEPS
        for mine, want in zip(run["records"], records):
            for key in ("loss", "task_loss", "accuracy"):
                assert _rel(mine[key], want[key]) <= 1e-5, (r, key)
        _assert_trees_close(run["params"], final, 1e-5, f"rank {r}")


@pytest.mark.parametrize("name", AR_CASES)
def test_allreduce_on_the_mesh_matches_the_reference(ranks, reference, name):
    losses, final = reference[("ar", name)]
    for r, rank in enumerate(ranks):
        run = rank["ar"][name]
        for mine, want in zip(run["records"], losses):
            assert _rel(mine["loss"], want) <= 1e-4, (r, mine["step"])
        _assert_trees_close(run["params"], final, 1e-4,
                            f"rank {r} vs the reference")


def test_one_pod_off_steps_match_the_single_device_step(ranks, single):
    """Both resnet50 peers on one pod's (2, 4) devices exchanging every
    other step: the off step's task-only loss over (B, classes) rows
    (``_plain_task_metrics``) and every step within 1e-5 of the port's
    single-device ``PredictionExchange`` at the same period, the frozen
    stages unchanged as there."""
    records, final = single["one_pod"]
    for r, rank in enumerate(ranks):
        run = rank["one_pod"]
        assert [m["distill_loss"] > 0 for m in run["records"]] == [
            True, False, True]
        for mine, want in zip(run["records"], records):
            for key in ("loss", "task_loss", "accuracy"):
                assert _rel(mine[key], want[key]) <= 1e-5, (r, key)
        for got, want in zip(run["params"], final):
            _assert_trees_close(got, want, 1e-5, f"rank {r}")


@pytest.mark.parametrize("case", CODIST_CASES + [(n, None) for n in AR_CASES],
                         ids=lambda c: (f"{c[0]}-" + ("allreduce" if c[1] is None
                                                      else "x".join(map(str, c[1])))))
def test_eval_on_the_mesh_matches_the_single_device_eval(ranks, single, case):
    """The strategy's eval (``make_eval``: a pod's rows gathered for
    codist, the batch placed over pod x data for the baseline) of the
    final parameters on the first batch, over tokens, images or features,
    within 1e-5 of the single-device eval on every rank."""
    name, shape = case
    want = single[name if shape else ("ar", name)][2]
    for r, rank in enumerate(ranks):
        got = rank["codist"][case]["eval"] if shape else rank["ar"][name][
            "eval"]
        for key in EVAL_KEYS:
            assert _rel(got[key], want[key]) <= 1e-5, (r, key)


@pytest.mark.parametrize("case", [c for c in CODIST_CASES if c[0] in ENCDEC]
                         + [("tbig-src", None)], ids=lambda c: (
                             f"{c[0]}-" + ("allreduce" if c[1] is None
                                           else "x".join(map(str, c[1])))))
def test_encdec_shards_follow_the_rules(ranks, case):
    """On every rank each parameter and moment leaf of an enc-dec tree has
    the local shard of its spec: a peer's under ``state_shardings`` of the
    stacked state (the peer axis on "pod"), the baseline's one model's
    under ``state_shardings(..., stacked=False)`` (nothing over "pod").
    The attention's q/k/v (self and cross) go FSDP + TP by heads
    (``slide=False``), the gelu FFN in the Megatron layout, the norms
    whole."""
    name, shape = case
    mesh = make_host_mesh(shape or MESH)
    seen = set()
    for r, rank in enumerate(ranks):
        run = rank["ar"][name] if shape is None else rank["codist"][case]
        for path, full, local in run["locals"]:
            leaf = path.split("/", 2 if path.startswith("opt/") else 1)[-1]
            if shape is None:
                spec = sh.param_spec(leaf, full, mesh,
                                     scanned=sh._scanned(leaf))
                assert "pod" not in sh.spec_axes(spec), (path, spec)
            else:
                spec = sh.param_spec(leaf, (N, *full), mesh, stacked=True,
                                     scanned=sh._scanned(leaf))
                assert spec[0] == "pod", (path, spec)
                spec = spec[1:]
            assert local == sh.local_shape(full, spec, mesh), (r, path)
            seen.add(leaf.rsplit("/", 2)[-2] if "/" in leaf else leaf)
    assert {"attn", "self_attn", "cross_attn", "ffn", "norm_x"} <= seen


def _cost(name, mode, rows):
    return step_cost(_cfg(name), InputShape("traffic", S, rows, "train"),
                     mode, codist_n=N, mesh=make_host_mesh(MESH)
                     ).collectives.cross_pod_bytes


@pytest.mark.parametrize("name", ["resnet50", "tbig-src"])
def test_cross_pod_traffic_codist_vs_allreduce(ranks, name):
    """The reference's traffic test for the paper's models: on (2, 2, 2)
    the bytes a device sends across pods a step, metered (the pod group's
    gather of the wire for codist, the optimizer's reduction over "pod"
    for the baseline), equal ``launch/cost.py``'s ``cross_pod_bytes`` of
    the same step; both are above 0, and codist's are below the
    baseline's (the paper's b_pred against b_model)."""
    ar_cost = _cost(name, "allreduce", B)
    cd_cost = _cost(name, "codist", N * B_PEER)
    for r, rank in enumerate(ranks):
        assert rank["ar"][name]["pod_bytes"] == STEPS * ar_cost, r
        run = rank["codist"][(name, MESH)]
        # the pod group meters a shard once a pod: a classifier's wire is
        # whole over "model", so its replica of model coordinate 1
        # receives the same bytes unmetered
        metered = name in ENCDEC or run["coordinate"][2] == 0
        assert run["wire_bytes"] == STEPS * cd_cost * metered, (
            r, run["wire_bytes"])
    assert ar_cost > 0 and cd_cost > 0
    assert cd_cost < ar_cost, (cd_cost, ar_cost)


@pytest.mark.parametrize("comp, topk", [("none", 64), ("topk", 64),
                                        ("topk", 4)])
@pytest.mark.parametrize("arch", ["resnet50", "mlp"])
def test_cost_prices_a_classifiers_wire(arch, comp, topk):
    """``step_cost`` of a classifier's codist step on (2, 2, 1) prices the
    wire at one row an example (``comm_model.prediction_bits_classifier``,
    its classes whole on every device): 64 examples of 2 peers are 16 rows
    a device, each receiving the other pod's 16 rows of fp32 logits, or of
    the top-k values with their int32 indices (k at most the classes)."""
    cfg = get_config("resnet50") if arch == "resnet50" else MLPConfig()
    mesh = make_host_mesh((2, 2, 1))
    cost = step_cost(cfg, InputShape("wire", 1, 64, "train"), "codist",
                     mesh=mesh, codist_extra={"compression": comp,
                                              "topk": topk})
    ops = [o for o in cost.collectives.ops if o.cross_pod]
    assert [o.line for o in ops] == [f"codist wire ({comp})"]
    classes = cfg.num_classes
    row = classes * 4 if comp == "none" else min(topk, classes) * 8
    assert cost.collectives.cross_pod_bytes == 16 * row
    want = {("resnet50", "none"): 64000, ("mlp", "none"): 640,
            ("resnet50", "topk"): 16 * topk * 8,
            ("mlp", "topk"): 16 * min(topk, 10) * 8}[(arch, comp)]
    assert cost.collectives.cross_pod_bytes == want
    # the baseline's gradient sync is the model's fp32 bytes a device
    ar = step_cost(cfg, InputShape("wire", 1, 64, "train"), "allreduce",
                   mesh=mesh).collectives.cross_pod_bytes
    if arch == "resnet50":
        assert ar == 102_162_688
