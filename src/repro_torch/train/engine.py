"""Step engine: one ``build_train_step`` for every exchange mechanism.

The paper compares synchronization mechanisms (Section 3). Each is an
``ExchangeStrategy``; ``build_train_step`` threads the shared pieces through
every strategy once: the LR / weight-decay / label-smoothing / alpha
schedules of ``state.step``, microbatched gradient accumulation, and the
optimizer update with its ``trainable`` mask. A strategy supplies what
differs: ``plan(step)`` (which variant runs, whether an exchange happens),
``distill_targets`` (live logits, the stale replicas' predictions, the
previous step's logits), ``loss``, ``host_exchange``, ``post_update`` and
``comm_bytes``.

    strategy = resolve_strategy(codist)
    bundle   = build_train_step(model, tc, codist, strategy, trainable)
    state    = strategy.init_state(model, tc, generator, opt_init, device=...)
    state, metrics, plan = bundle.apply(state, batch, k)

The port runs eagerly: a step variant is a Python function (forward,
``torch.autograd.grad``, in-place optimizer update), not a compiled one.
Metrics stay tensors on the device until the loop logs them.

A state whose parameters are DTensors (``launch/sharding.py``'s
``distribute_state``: a peer placed on its pod's ("data", "model") mesh,
FSDP over "data", TP over "model") runs the same step on that mesh
(``on_mesh``): plain tensors made inside the step (positions, masks,
constants) count as replicated, the model's ``hint`` calls place the
activations as the reference's ``activation_sharding`` context does, the
loss kernels run on local rows (``kernels/ops.py``) and the optimizer on
local shards; the metrics come back as plain tensors, the same on every
rank. ``PredictionExchange`` takes such a state of n peers on one pod and
its batch from ``distribute_batch``; ``ShardMapCompressed`` on a mesh
holds one peer a pod and places its state and batch itself.

Strategies: ``AllReduce`` (the gradient-sync baseline: one model),
``PredictionExchange`` (Algorithm 1 with coordinated sampling, "on" and
"off" variants), ``CheckpointExchange`` (Anil et al.'s stale replicas,
refreshed on the host every ``period`` steps), ``PipelinedPredictions``
(the previous step's logits, with a replay forward on the previous batch),
``AsyncPrediction`` (one peer of the async runtime, ``repro_torch.
runtime``, its targets from the mailbox) and ``ShardMapCompressed`` (one
process per model in a ``torch.distributed`` pod group, exchanging only
the compressed wire).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import CodistConfig, TrainConfig, torch_dtype
from repro_torch.core import codistillation as cd
from repro_torch.core import comm_model as cm
from repro_torch.core import schedules as sched
from repro_torch.core.exchange import StepPlan
from repro_torch.optim import OptState, make_optimizer
from repro_torch.train.state import (CodistState, TrainState,
                                     init_codist_state, init_peer_state,
                                     init_train_state, snapshot_params,
                                     trainable_params)
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


# ----------------------------------------------------------------------------
# schedule bundle (shared by every strategy)
# ----------------------------------------------------------------------------

class Schedules(NamedTuple):
    lr: Callable
    wd: Callable
    ls: Callable
    alpha: Callable


def make_schedules(tc: TrainConfig, codist: Optional[CodistConfig] = None):
    lr_fn = sched.make_lr_fn(tc.lr_schedule, tc.lr, tc.total_steps,
                             tc.warmup_steps, tc.step_milestones, tc.step_decay)
    if tc.weight_decay_schedule:
        values = tuple(tc.weight_decay_schedule)
        miles = tc.step_milestones[: len(values) - 1]

        def wd_fn(s):
            return sched.scheduled_weight_decay(s, tc.total_steps, values, miles)
    else:
        def wd_fn(s):
            return sched.constant_weight_decay(s, tc.weight_decay)
    if tc.label_smoothing_decay:
        def ls_fn(s):
            return sched.decayed_label_smoothing(s, tc.total_steps,
                                                 tc.label_smoothing)
    else:
        def ls_fn(s):
            return float(tc.label_smoothing)
    if codist is not None:
        def alpha_fn(s):
            return sched.alpha_schedule(s, codist.alpha0, codist.alpha_growth,
                                        codist.steps_per_epoch,
                                        codist.burn_in_steps)
    else:
        def alpha_fn(s):
            return 0.0
    return lr_fn, wd_fn, ls_fn, alpha_fn


# ----------------------------------------------------------------------------
# shared forward / gradient-accumulation helpers
# ----------------------------------------------------------------------------

def _task_forward(model, params: PyTree, batch: Dict, remat: bool):
    """One forward over LM / enc-dec / conv / MLP models: a config with a
    ``kind`` (``ConvConfig``, ``MLPConfig``) takes no ``remat``."""
    if hasattr(model.cfg, "kind"):
        return model.forward(params, batch)
    return model.forward(params, batch, remat=remat)


def _peer_batch(batch_all: Dict, i: int) -> Dict:
    return {k: v[i] for k, v in batch_all.items()}


def _stacked_forward(model, peer_params, batch_all: Dict, remat: bool):
    """Forward of each peer on its slice of ``batch_all`` (leading n axis):
    a loop over peers where the reference vmaps. Returns (list of logits,
    (n,) aux)."""
    logits, aux = [], []
    for i, params in enumerate(peer_params):
        lg, a = _task_forward(model, params, _peer_batch(batch_all, i), remat)
        logits.append(lg)
        aux.append(a)
    return logits, torch.stack(aux)


def _detach_metrics(metrics: Dict) -> Dict:
    return {k: (v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in metrics.items()}


def _grads_metrics_aux(loss_fn, params: PyTree, batch: Dict, k: int,
                       accum_dtype=torch.float32):
    """Gradients of ``loss_fn(params, batch) -> (loss, (metrics, aux))``
    with respect to every leaf of ``params``.

    k > 1 accumulates over microbatches: every batch leaf carries a leading
    (k, ...) axis, each microbatch's gradient is added in ``accum_dtype``
    divided by k, and metrics are averaged over microbatches; ``aux`` is the
    list of the microbatches' aux values. ``batch`` may nest dicts (the
    pipelined operand). On a mesh the accumulators are DTensors in the
    placements of the first microbatch's gradients (a ``Partial`` sum over
    the batch axes stays one until the optimizer places it), so a step
    reduces each gradient over "pod" once, not once a microbatch."""
    leaves = tree_leaves(params)
    if k <= 1:
        total, (metrics, aux) = loss_fn(params, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return _unflatten(params, grads), _detach_metrics(metrics), aux

    g_acc = [None] * len(leaves)
    m_acc: Dict = {}
    auxs = []
    for j in range(k):
        mb = tree_map(lambda v: v[j], batch)
        total, (m, aux) = loss_fn(params, mb)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        for i, g in enumerate(grads):
            if g is None:
                continue
            g = g.to(accum_dtype) / k
            if g_acc[i] is None:
                g_acc[i] = g
            else:
                g_acc[i].add_(g)
        for name, v in _detach_metrics(m).items():
            m_acc[name] = m_acc.get(name, 0.0) + v / k
        auxs.append(aux)
    g_acc = [torch.zeros_like(p, dtype=accum_dtype) if g is None else g
             for p, g in zip(leaves, g_acc)]
    return _unflatten(params, g_acc), m_acc, auxs


def mesh_of(params: PyTree):
    """The DeviceMesh of a state's parameters, or None for plain tensors."""
    from repro_torch.kernels.ops import is_dtensor
    leaves = tree_leaves(params)
    return leaves[0].device_mesh if leaves and is_dtensor(leaves[0]) else None


def on_mesh(params: PyTree):
    """The context a step over ``params`` runs in: on a mesh (DTensor
    parameters) plain tensors count as replicated and the hints place the
    activations (TP over "model"; the batch over ("pod", "data") for one
    model over the whole mesh, over "data" for a peer on its pod's ("data",
    "model") devices, as the reference's dry run sets
    ``activation_sharding``); else no context."""
    import contextlib
    mesh = mesh_of(params)
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models.sharding_hints import activation_sharding
    stack = contextlib.ExitStack()
    stack.enter_context(implicit_replication())
    names = mesh.mesh_dim_names
    stack.enter_context(activation_sharding(
        ("pod", "data") if "pod" in names else ("data",), "model",
        mesh.size(names.index("model"))))
    return stack


def plain_metrics(metrics: Dict) -> Dict:
    """Every DTensor metric as its full value (a collective, in the dict's
    order on every rank); the rest as given."""
    from repro_torch.kernels.ops import is_dtensor
    return {k: (v.full_tensor() if is_dtensor(v) else v)
            for k, v in metrics.items()}


def _unflatten(tree: PyTree, flat) -> PyTree:
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def _param_bits(params: PyTree, n: int = 1) -> float:
    """Bits of one model's parameter vector (a peer list carries n models)."""
    total = sum(x.numel() * x.element_size() * 8 for x in tree_leaves(params))
    return total / max(1, n)


def _plain_task_metrics(codist, logits_all, batch, ls, fused):
    """Task-only loss over the peers (the prediction off-step)."""
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    task = torch.stack([cd.cross_entropy(lg, labels[i], ls, mask[i],
                                         fused=fused)
                        for i, lg in enumerate(logits_all)])
    total = task.mean()
    zero = torch.zeros((), dtype=torch.float32, device=total.device)
    metrics = {"loss": total, "task_loss": total, "distill_loss": zero,
               "task_loss_per_model": task,
               "distill_loss_per_model": torch.zeros_like(task),
               "alpha": zero}
    return total, metrics


# ----------------------------------------------------------------------------
# the strategy protocol
# ----------------------------------------------------------------------------

class ExchangeStrategy:
    """Pluggable Section-3 synchronization mechanism. Host-side API:
    ``init_state``, ``ensure_state``, ``plan``, ``variant_for``,
    ``host_exchange``, ``comm_bytes``, ``make_eval``; per step:
    ``prepare``, ``distill_targets``, ``loss``, ``post_update``."""

    name = "base"
    variants: Tuple[str, ...] = ("on",)
    stacked = True   # CodistState with n peers (vs single TrainState)

    def __init__(self, codist: Optional[CodistConfig] = None):
        self.codist = codist

    # ---- host side ---------------------------------------------------------
    def init_state(self, model, tc: TrainConfig, generator, opt_init,
                   example_batch: Optional[Dict] = None, device="cuda"):
        return init_codist_state(model, generator, self.codist.n_models,
                                 opt_init, device=device)

    def ensure_state(self, state, model, tc: TrainConfig,
                     example_batch: Optional[Dict] = None):
        """Add strategy-specific state to a user-supplied ``state``."""
        return state

    def plan(self, step: int) -> StepPlan:
        raise NotImplementedError

    def variant_for(self, plan: StepPlan) -> str:
        return "on"

    def host_exchange(self, state):
        """Host-side exchange action (checkpoint mode refreshes the stale
        replicas); the other mechanisms exchange inside the step."""
        return state

    def comm_bytes(self, model, state, batch_all: Dict,
                   microbatch: int = 0) -> float:
        """Bytes crossing the slow (cross-pod) links per exchange EVENT."""
        return 0.0

    def make_eval(self, model, tc: TrainConfig) -> Callable:
        return make_codist_eval_step(model, tc)

    # ---- per step ----------------------------------------------------------
    def prepare(self, state, batch_all: Dict, k: int):
        """Microbatch axis in front of the peer axis: (n, k, B/k, ...) ->
        (k, n, B/k, ...)."""
        if k > 1:
            return tree_map(lambda v: v.transpose(0, 1), batch_all)
        return batch_all

    def distill_targets(self, model, tc: TrainConfig, state, batch: Dict,
                        logits_all) -> Dict:
        """kwargs for ``codist_loss`` selecting the distillation targets
        (none: the live logits)."""
        return {}

    def loss(self, model, tc: TrainConfig, sch: Schedules, state, params,
             batch: Dict, variant: str):
        """``(total, metrics, aux)`` for one (micro)batch."""
        logits_all, aux_all = _stacked_forward(model, params, batch, tc.remat)
        if variant == "on":
            total, metrics = cd.codist_loss(
                self.codist, logits_all, batch["labels"],
                sch.alpha(state.step), sch.ls(state.step), batch.get("mask"),
                fused=tc.fused_losses,
                **self.distill_targets(model, tc, state, batch, logits_all))
        else:
            total, metrics = _plain_task_metrics(
                self.codist, logits_all, batch, sch.ls(state.step),
                tc.fused_losses)
        total = total + aux_all.mean()
        metrics["aux_loss"] = aux_all.mean()
        metrics["accuracy"] = torch.stack([
            cd.accuracy(lg.detach(), batch["labels"][i])
            for i, lg in enumerate(logits_all)]).mean()
        return total, metrics, None

    def post_update(self, state, params, opt, batch_all: Dict, aux, k: int):
        return CodistState(params, opt, state.step + 1, state.stale,
                           state.peer)


# ----------------------------------------------------------------------------
# concrete strategies
# ----------------------------------------------------------------------------

class AllReduce(ExchangeStrategy):
    """Data-parallel baseline: the gradient all-reduce crosses the pod links
    every step (C_AR = 2 * b_model bits/iter, Section 3). One model.

    On a mesh (``mesh``: this process's ``PodGroup`` of ``spawn_pods(...,
    mesh=)``, or its ``DeviceMesh``; one process a device of a (pod, data,
    model) mesh) the one model spans every device, as the reference's dry
    run places it: ``init_state`` / ``ensure_state`` distribute its state
    (``distribute_state`` with no peer count: FSDP over "data", TP over
    "model", replicated over "pod"), ``prepare`` and the eval its batch
    (rows over ("pod", "data"), each microbatch's as a batch's). The
    gradient comes out of the backward as a ``Partial`` sum over the batch
    axes; the optimizer places it on its parameter's shards, reducing over
    "pod" last, and meters that cross-pod all-reduce
    (``optim/optimizers.py`` ``pod_sync``). ``moe_expert_axis`` places the
    expert stacks' E dim over that axis (expert parallelism, the rows
    exchanged by an all-to-all in ``models/moe.py``); an expert's gradient
    is then whole on its rank but for the sum over "pod"."""

    name = "all_reduce"
    stacked = False

    def __init__(self, codist: Optional[CodistConfig] = None, mesh=None,
                 *, moe_expert_axis: Optional[str] = None):
        super().__init__(codist)
        from repro_torch.launch.mesh import PodGroup
        self.device_mesh = mesh.mesh if isinstance(mesh, PodGroup) else mesh
        self.moe_expert_axis = moe_expert_axis

    @property
    def mesh(self):
        """The logical (pod, data, model) mesh of the devices, or None."""
        if self.device_mesh is None:
            return None
        from repro_torch.launch.mesh import logical_mesh
        return logical_mesh(self.device_mesh)

    def init_state(self, model, tc, generator, opt_init, example_batch=None,
                   device="cuda"):
        """``init_train_state``'s draw; on a mesh the parameters are placed
        first and the optimizer's moments made from the placed ones."""
        if self.device_mesh is None:
            return init_train_state(model, generator, opt_init,
                                    device=device)
        params = trainable_params(model.init(generator, device=device))
        state = self.ensure_state(TrainState(params, OptState(0, None, None),
                                             0), model, tc)
        return state._replace(opt=opt_init(state.params))

    def ensure_state(self, state, model, tc, example_batch=None):
        """On a mesh, a state of plain tensors placed on its devices."""
        if self.device_mesh is None or mesh_of(state.params) is not None:
            return state
        from repro_torch.launch.sharding import distribute_state
        return distribute_state(state, self.mesh, self.device_mesh,
                                moe_expert_axis=self.moe_expert_axis)

    def _placed(self, batch: Dict, k: int) -> Dict:
        if self.device_mesh is None:
            return batch
        from repro_torch.launch.sharding import distribute_batch
        return distribute_batch(batch, self.mesh, self.device_mesh,
                                stacked=False, microbatched=k > 1)

    def plan(self, step: int) -> StepPlan:
        return StepPlan(distill=False, exchange=True)

    def comm_bytes(self, model, state, batch_all, microbatch=0) -> float:
        return 2.0 * _param_bits(state.params) / 8.0

    def make_eval(self, model, tc):
        plain = make_eval_step(model, tc)
        if self.device_mesh is None:
            return plain

        def eval_step(params, batch: Dict) -> Dict:
            with on_mesh(params):
                return plain_metrics(plain(params, self._placed(batch, 1)))
        return eval_step

    def loss(self, model, tc, sch, state, params, batch, variant):
        logits, aux = _task_forward(model, params, batch, tc.remat)
        task = cd.cross_entropy(logits, batch["labels"], sch.ls(state.step),
                                batch.get("mask"), fused=tc.fused_losses)
        metrics = {"loss": task + aux, "task_loss": task, "aux_loss": aux,
                   "accuracy": cd.accuracy(logits.detach(), batch["labels"],
                                           batch.get("mask"))}
        return task + aux, metrics, None

    def prepare(self, state, batch_all, k):
        # single-model batches already carry the (k, B/k, ...) layout
        return self._placed(batch_all, k)

    def post_update(self, state, params, opt, batch_all, aux, k):
        return TrainState(params, opt, state.step + 1)


class PredictionExchange(ExchangeStrategy):
    """Algorithm 1 with coordinated sampling: on exchange steps every peer's
    live logits are the distillation targets; off steps run a variant that
    omits the distillation term (Section 3's periodic exchange)."""

    name = "prediction"
    variants = ("on", "off")

    def plan(self, step: int) -> StepPlan:
        return StepPlan.for_step(replace(self.codist, mode="predictions"),
                                 step)

    def variant_for(self, plan: StepPlan) -> str:
        return "on" if plan.distill else "off"

    def comm_bytes(self, model, state, batch_all, microbatch=0) -> float:
        """(n-1) peers' fp32 logits of every sample of the batch: a
        sequence of an LM (labels (n, [k,] B, S)), or one logit vector of a
        classifier (labels (n, B)). A model without the Section-3
        metadata (no ``num_classes``) reports 0, as the reference's."""
        cfg = self.codist
        try:
            labels = batch_all["labels"]
            n = cfg.n_models
            mcfg = getattr(model, "cfg", None)
            if labels.dim() >= 3:         # LM: (n, [k,] B, S)
                seq = labels.shape[-1]
                samples = labels.numel() // (n * seq)
                b_pred = cm.prediction_bits_lm(mcfg, seq, 32, cfg.compression,
                                               cfg.topk, cfg.subsample)
            else:                         # classifier: (n, B)
                samples = labels.numel() // n
                b_pred = cm.prediction_bits_classifier(mcfg.num_classes)
            return (n - 1) * b_pred * samples / 8.0
        except (KeyError, AttributeError, TypeError):
            return 0.0


class CheckpointExchange(PredictionExchange):
    """Anil et al.'s variant: every step each peer draws its OWN batch and
    distills against the stale replicas' predictions on it (n - 1 extra
    gradient-free forwards per peer); every ``period`` steps the host
    refreshes ``state.stale`` (``refresh_stale``, the cross-pod parameter
    all-gather)."""

    name = "checkpoint"
    variants = ("on",)

    def init_state(self, model, tc, generator, opt_init, example_batch=None,
                   device="cuda"):
        return init_codist_state(model, generator, self.codist.n_models,
                                 opt_init, device=device, with_stale=True)

    def ensure_state(self, state, model, tc, example_batch=None):
        if state.stale is None:   # user-supplied state without replicas
            return state._replace(stale=snapshot_params(state.params))
        return state

    def plan(self, step: int) -> StepPlan:
        # distill EVERY step against the stale replicas (even during
        # burn-in, where alpha is 0); exchange every period
        p = StepPlan.for_step(replace(self.codist, mode="checkpoints"), step)
        return StepPlan(True, p.exchange)

    def host_exchange(self, state):
        return refresh_stale(state)

    def comm_bytes(self, model, state, batch_all, microbatch=0) -> float:
        n = self.codist.n_models
        return (n - 1) * _param_bits(state.params, n) / 8.0

    @torch.no_grad()
    def distill_targets(self, model, tc, state, batch, logits_all):
        """``peer_pairwise[i][j]`` = stale replica j's logits on peer i's
        (micro)batch. The reference computes all n x n forwards;
        ``codist_loss`` never reads the diagonal, so it stays None here."""
        n = len(state.stale)
        pairwise = [[None if j == i else
                     _task_forward(model, state.stale[j],
                                   _peer_batch(batch, i), tc.remat)[0]
                     for j in range(n)] for i in range(n)]
        return {"peer_pairwise": pairwise}


class PipelinedPredictions(ExchangeStrategy):
    """Beyond-paper: distill against the PREVIOUS step's peer logits,
    replaying the previous (coordinated) batch for the distillation term,
    so the logits collective of step k - 1 can overlap step k's compute.

    ``state.peer = {"batch": previous batch_all, "logits": previous logits
    (n, [k,] B, S, V) fp32, "valid": bool}``; with microbatching both carry
    the (n, k, B/k, ...) layout so the replay pairs microbatch m with its
    own logits. ``post_update`` writes the new logits into the buffer in
    place (it is 5 GB at full width for two peers)."""

    name = "pipelined"

    def init_state(self, model, tc, generator, opt_init, example_batch=None,
                   device="cuda"):
        state = init_codist_state(model, generator, self.codist.n_models,
                                  opt_init, device=device)
        return self.ensure_state(state, model, tc, example_batch)

    def ensure_state(self, state, model, tc, example_batch=None):
        if state.peer is not None or example_batch is None:
            return state
        n = self.codist.n_models
        k = tc.microbatch
        lead = (n, k) if k > 1 else (n,)
        # the logits' shape from a forward of peer 0 on (microbatch 0 of)
        # its slice, on the meta device: shapes only, as the reference's
        # eval_shape
        meta = tree_map(lambda x: x.detach().to("meta"),
                        {"params": state.params[0],
                         "batch": tree_map(lambda x: x[0][0] if k > 1
                                           else x[0], example_batch)})
        with torch.no_grad():
            shape = _task_forward(model, meta["params"], meta["batch"],
                                  False)[0].shape
        return state._replace(peer=init_peer_state(example_batch,
                                                   lead + tuple(shape)))

    def plan(self, step: int) -> StepPlan:
        # the (stale) logits collective overlaps every step
        return StepPlan(True, True)

    def comm_bytes(self, model, state, batch_all, microbatch=0) -> float:
        return PredictionExchange.comm_bytes(self, model, state, batch_all,
                                             microbatch)

    def prepare(self, state, batch_all, k):
        operand = {"batch": batch_all, "peer_batch": state.peer["batch"],
                   "peer_logits": state.peer["logits"]}
        if k > 1:
            operand = tree_map(lambda v: v.transpose(0, 1), operand)
        return operand

    def loss(self, model, tc, sch, state, params, operand, variant):
        batch, peer_batch = operand["batch"], operand["peer_batch"]
        ls = sch.ls(state.step)
        logits_all, aux_all = _stacked_forward(model, params, batch, tc.remat)
        labels, mask = batch["labels"], batch.get("mask")
        task = torch.stack([
            cd.cross_entropy(lg, labels[i], ls,
                             None if mask is None else mask[i],
                             fused=tc.fused_losses)
            for i, lg in enumerate(logits_all)])
        # replay forward on the previous batch for the distillation term
        replay_logits, _ = _stacked_forward(model, params, peer_batch,
                                            tc.remat)
        _, dmetrics = cd.codist_loss(
            self.codist, replay_logits, peer_batch["labels"],
            sch.alpha(state.step), 0.0, peer_batch.get("mask"),
            peer_logits_all=operand["peer_logits"], fused=tc.fused_losses)
        dist = dmetrics["distill_loss_per_model"]
        alpha = sch.alpha(state.step) * float(state.peer["valid"])
        total = (task + alpha * dist).mean() + aux_all.mean()
        metrics = {"loss": total, "task_loss": task.mean(),
                   "distill_loss": dist.mean(), "alpha": alpha,
                   "aux_loss": aux_all.mean(),
                   "accuracy": torch.stack([
                       cd.accuracy(lg.detach(), labels[i])
                       for i, lg in enumerate(logits_all)]).mean()}
        return total, metrics, [lg.detach() for lg in logits_all]

    @torch.no_grad()
    def post_update(self, state, params, opt, batch_all, aux, k):
        buf = state.peer["logits"]
        for i in range(len(params)):
            if k > 1:          # aux: k microbatches x n peers
                for j, peers in enumerate(aux):
                    buf[i, j].copy_(peers[i])
            else:
                buf[i].copy_(aux[i])
        new_peer = {"batch": batch_all, "logits": buf, "valid": True}
        return CodistState(params, opt, state.step + 1, state.stale, new_peer)


class AsyncPrediction(ExchangeStrategy):
    """Single-peer view of the prediction exchange for the async runtime.

    Each peer runs on its OWN step clock, so a step sees only this peer's
    params and the distillation targets arrive from the host (mailbox
    payloads posted by peers on their own clocks). The operand is::

        {"batch": <single-model batch>,
         "peer_wire":      a list of P compressed wires (``compress_targets``
                           on the producer side), one per target slot; an
                           absent peer's slot holds the runtime's shared
                           zero wire, which nothing writes
         "peer_weight":    (P,)  1.0 accepted / 0.0 dropped-or-missing
         "peer_staleness": (P,)  receiver_step - sender_step}

    (The reference stacks the slots on a leading axis; a list spares the
    copy of every payload into a fresh stack each step, 2.5 GB a slot at
    qwen1.5-0.5b's full width.)

    The loss is ``(task + alpha * dist + aux) / n_slots``: this peer's share
    of ``codist_loss``'s mean over n models (every other model's term is a
    constant with respect to this peer's params), so with fresh same-step
    targets the gradient, and hence the trajectory, matches the synchronous
    engine. One distillation term is computed per target slot; the weights
    implement the staleness-bound drop policy: dropped peers contribute
    nothing, and when every payload is dropped the distillation term (and
    alpha) vanishes — the step degrades to plain task training instead of
    blocking (Anil et al., arXiv:1804.03235). Metrics report the UNSCALED
    task / distill terms and the measured staleness of the targets used.
    """

    name = "async_prediction"
    variants = ("on", "off")
    stacked = False

    def __init__(self, codist: CodistConfig, n_slots: Optional[int] = None):
        super().__init__(codist)
        # the divisor of the codist mean AND 1 + number of target slots;
        # fixed at build time so elastic membership keeps the slot count
        self.n_slots = max(2, n_slots or codist.n_models)

    def init_state(self, model, tc, generator, opt_init, example_batch=None,
                   device="cuda"):
        return init_train_state(model, generator, opt_init, device=device)

    def plan(self, step: int) -> StepPlan:
        # standalone use mirrors the synchronous prediction schedule; the
        # AsyncScheduler picks variants from mailbox availability
        return StepPlan.for_step(replace(self.codist, mode="predictions"),
                                 step)

    def variant_for(self, plan: StepPlan) -> str:
        return "on" if plan.distill else "off"

    def make_eval(self, model, tc):
        return make_eval_step(model, tc)

    def comm_bytes(self, model, state, operand, microbatch=0) -> float:
        cfg = self.codist
        try:
            batch = operand["batch"] if "batch" in operand else operand
            labels = batch["labels"]
            seq = labels.shape[-1]
            samples = labels.numel() // seq
            b_pred = cm.prediction_bits_lm(model.cfg, seq, 32,
                                           cfg.compression, cfg.topk,
                                           cfg.subsample)
            return (self.n_slots - 1) * b_pred * samples / 8.0
        except (KeyError, AttributeError, TypeError):
            return 0.0

    def prepare(self, state, operand, k):
        if k <= 1:
            return operand
        # batch and wire leaves already lead with the microbatch axis (k,
        # B/k, ...); the per-slot vectors are tiled so that the
        # accumulation loop can take microbatch j of every leaf
        p = operand["peer_weight"].shape[0]
        return {"batch": operand["batch"], "peer_wire": operand["peer_wire"],
                "peer_weight": operand["peer_weight"].expand(k, p),
                "peer_staleness": operand["peer_staleness"].expand(k, p)}

    def loss(self, model, tc, sch, state, params, operand, variant):
        batch = operand["batch"] if "batch" in operand else operand
        logits, aux = _task_forward(model, params, batch, tc.remat)
        mask = batch.get("mask")
        task = cd.cross_entropy(logits, batch["labels"], sch.ls(state.step),
                                mask, fused=tc.fused_losses)
        acc = cd.accuracy(logits.detach(), batch["labels"], mask)
        n = self.n_slots
        zero = torch.zeros((), dtype=torch.float32, device=task.device)
        if variant != "on":
            total = (task + aux) / n
            metrics = {"loss": total, "task_loss": task,
                       "distill_loss": zero, "aux_loss": aux, "alpha": zero,
                       "accuracy": acc, "staleness": zero,
                       "peer_weight": zero}
            return total, metrics, None
        w = operand["peer_weight"].float()
        st = operand["peer_staleness"].float()
        d = torch.stack([cd.distill_vs_compressed(self.codist, logits, wire,
                                                  mask, fused=tc.fused_losses)
                         for wire in operand["peer_wire"]])
        wsum = w.sum()
        denom = torch.clamp(wsum, min=1.0)   # == n-1 with a full fresh mailbox
        dist = (w * d).sum() / denom
        stale = (w * st).sum() / denom
        alpha = sch.alpha(state.step) * (wsum > 0).float()
        total = (task + alpha * dist + aux) / n
        metrics = {"loss": total, "task_loss": task, "distill_loss": dist,
                   "aux_loss": aux, "alpha": alpha, "accuracy": acc,
                   "staleness": stale, "peer_weight": wsum}
        return total, metrics, None

    def post_update(self, state, params, opt, batch_all, aux, k):
        return TrainState(params, opt, state.step + 1)


class ShardMapCompressed(PredictionExchange):
    """Prediction exchange with an explicitly scheduled compressed wire,
    one process per model.

    The reference shard_maps over a ``"pod"`` mesh axis; the port runs
    each model in its own process of a ``PodGroup`` (``launch/mesh.py``),
    which holds only its own peer's parameters and optimizer state (a
    ``TrainState``). Each pod computes its model's forward, task CE and
    compressed wire locally, and the all-gather of the wire is the ONLY
    cross-pod collective (``cd.codist_loss`` with the pod group); the wire
    is detached before it is sent, so the backward stays pod-local. The
    step's loss is the mean over models of task + alpha * dist + aux, in
    which only this pod's row carries a gradient, so every pod's gradient
    is the one ``PredictionExchange`` gives that peer; the metrics average
    the rows gathered from every pod, with the per-model task and
    distillation losses. Off steps run the task-only loss on this pod's
    model.
    Every pod is handed the whole (n, ...) batch and takes its own slice.
    ``comm_bytes`` is ``PredictionExchange``'s accounting; the bytes that
    actually crossed are ``pods.wire_bytes``.

    On a mesh (a ``PodGroup`` of ``spawn_pods(..., mesh=)``, one process a
    device of a (pod, data, model) mesh) each pod's peer is placed on the
    pod's ("data", "model") devices: ``init_state`` / ``ensure_state``
    distribute it (``distribute_state``: FSDP over "data", TP over
    "model") and ``prepare`` its rows of the batch (``distribute_batch``).
    The wire is gathered shard by shard over the mesh's "pod" group, each
    rank sending its local shard of its pod's wire to the ranks that hold
    the same shard of the other pods' peers, and each received shard is
    re-wrapped with the placements it left with. Microbatches ``(n, k,
    B/k, ...)`` are placed as the reference's ``batch_shardings(...,
    microbatched=True)`` places them: each microbatch's rows over "data".
    ``moe_expert_axis`` places the peer's expert stacks' E dim over that
    axis of its pod (expert parallelism), as the reference's dry run's
    ``--moe-experts``."""

    name = "shardmap"
    stacked = False

    def __init__(self, codist: CodistConfig, mesh=None, *,
                 moe_expert_axis: Optional[str] = None):
        super().__init__(codist)
        from repro_torch.launch.mesh import PodGroup
        self.moe_expert_axis = moe_expert_axis
        if not isinstance(mesh, PodGroup):
            raise ValueError("ShardMapCompressed needs a pod group, one "
                             "process per model (repro_torch.launch.mesh."
                             f"init_pod_group); got {type(mesh).__name__}")
        if mesh.size != codist.n_models:
            raise ValueError(f"a pod group of {mesh.size} for "
                             f"{codist.n_models} models")
        self.pods = mesh

    def init_state(self, model, tc, generator, opt_init, example_batch=None,
                   device="cuda"):
        """This pod's peer, drawn as ``init_codist_state`` draws peer
        ``rank``: the inits of the pods before it are drawn and dropped.
        On a mesh the parameters are placed first and the optimizer's
        moments made from the placed ones (no device holds a whole peer's
        moments)."""
        for _ in range(self.pods.rank):
            model.init(generator, device=device)
        if self.pods.mesh is None:
            return init_train_state(model, generator, opt_init, device=device)
        params = trainable_params(model.init(generator, device=device))
        state = self.ensure_state(TrainState(params, OptState(0, None, None),
                                             0), model, tc)
        return state._replace(opt=opt_init(state.params))

    def ensure_state(self, state, model, tc, example_batch=None):
        """On a mesh, a state of plain tensors placed on this pod's
        devices."""
        if self.pods.mesh is None or mesh_of(state.params) is not None:
            return state
        from repro_torch.launch.sharding import distribute_state
        return distribute_state(state, self.mesh, self.pods.sub_mesh,
                                self.codist.n_models,
                                moe_expert_axis=self.moe_expert_axis)

    @property
    def mesh(self):
        """The logical (pod, data, model) mesh of the pods' devices."""
        from repro_torch.launch.mesh import logical_mesh
        return logical_mesh(self.pods.mesh)

    def _own_rows(self, batch_all: Dict, k: int = 1) -> Dict:
        """This pod's rows of an (n, [k,] B, ...) batch, placed on its
        devices on a mesh."""
        if self.pods.mesh is None:
            return _peer_batch(batch_all, self.pods.rank)
        from repro_torch.launch.sharding import distribute_batch
        return distribute_batch(batch_all, self.mesh, self.pods.sub_mesh,
                                peer=self.pods.rank, microbatched=k > 1)

    def prepare(self, state, batch_all, k):
        # (n, [k,] B, ...) -> this pod's ([k,] B, ...)
        return self._own_rows(batch_all, k)

    def make_eval(self, model, tc):
        """The codist eval of ``make_codist_eval_step``, gathered."""
        fused = tc.fused_losses if tc is not None else None

        @torch.no_grad()
        def eval_step(params, batch_all: Dict) -> Dict:
            with on_mesh(params):
                b = self._own_rows(batch_all)
                logits, _ = _task_forward(model, params, b, False)
                rows = cd.pod_rows(self.pods, torch.stack([
                    cd.cross_entropy(logits, b["labels"], fused=fused),
                    cd.accuracy(logits, b["labels"])]))
                return plain_metrics({
                    "eval_loss": rows[:, 0].mean(),
                    "eval_loss_per_model": rows[:, 0],
                    "eval_accuracy": rows[:, 1].mean(),
                    "eval_accuracy_per_model": rows[:, 1]})
        return eval_step

    def loss(self, model, tc, sch, state, params, batch, variant):
        logits, aux = _task_forward(model, params, batch, tc.remat)
        labels, mask = batch["labels"], batch.get("mask")
        ls = sch.ls(state.step)
        acc = cd.accuracy(logits.detach(), labels)
        if variant == "on":
            # (n,) task and distillation losses, this pod's entry with its
            # gradient, the others' gathered
            _, m = cd.codist_loss(
                self.codist, [logits], labels[None], sch.alpha(state.step),
                ls, None if mask is None else mask[None],
                fused=tc.fused_losses, pods=self.pods)
            task, dist, alpha = (m["task_loss_per_model"],
                                 m["distill_loss_per_model"], m["alpha"])
            rows = cd.pod_rows(self.pods, torch.stack([aux, acc]))
        else:
            rows = cd.pod_rows(self.pods, torch.stack([
                cd.cross_entropy(logits, labels, ls, mask,
                                 fused=tc.fused_losses), aux, acc]))
            task, rows = rows[:, 0], rows[:, 1:]
            dist = torch.zeros_like(task)
            alpha = torch.zeros((), dtype=torch.float32, device=task.device)
        total = (task + alpha * dist + rows[:, 0]).mean()
        metrics = {"loss": total, "task_loss": task.mean(),
                   "distill_loss": dist.mean(),
                   "aux_loss": rows[:, 0].mean(),
                   "task_loss_per_model": task,
                   "distill_loss_per_model": dist,
                   "alpha": alpha, "accuracy": rows[:, 1].mean()}
        return total, metrics, None

    def post_update(self, state, params, opt, batch_all, aux, k):
        return TrainState(params, opt, state.step + 1)


def resolve_strategy(codist: Optional[CodistConfig],
                     mesh=None) -> ExchangeStrategy:
    """CodistConfig -> strategy, as the reference dispatches: None ->
    AllReduce (over the ``mesh``'s devices where one is given); a
    ``mesh`` (this process's ``PodGroup``) -> ShardMapCompressed;
    ``pipelined`` -> PipelinedPredictions;
    ``mode="checkpoints"`` -> CheckpointExchange; else
    PredictionExchange."""
    if codist is None:
        return AllReduce(mesh=mesh)
    if mesh is not None:
        return ShardMapCompressed(codist, mesh)
    if codist.pipelined:
        return PipelinedPredictions(codist)
    if codist.mode == "checkpoints":
        return CheckpointExchange(codist)
    return PredictionExchange(codist)


# ----------------------------------------------------------------------------
# build_train_step: one step path for every strategy
# ----------------------------------------------------------------------------

class StepBundle:
    """The step variants of one strategy plus the plan-driven dispatcher."""

    def __init__(self, strategy: ExchangeStrategy,
                 variants: Dict[str, Callable], eval_fn: Callable):
        self.strategy = strategy
        self.variants = variants
        self.eval_fn = eval_fn

    def apply(self, state, batch_all: Dict, step_idx: int):
        """plan -> (optional) host exchange -> step variant. Returns
        ``(state, metrics, plan)``."""
        plan = self.strategy.plan(step_idx)
        if plan.exchange:
            state = self.strategy.host_exchange(state)
        state, metrics = self.variants[self.strategy.variant_for(plan)](
            state, batch_all)
        return state, metrics, plan


def build_train_step(model, tc: TrainConfig, codist: Optional[CodistConfig],
                     strategy: ExchangeStrategy,
                     trainable: Optional[PyTree] = None) -> StepBundle:
    """Every strategy's step variants share ONE schedules / optimizer /
    microbatch / trainable path."""
    codist = codist if codist is not None else strategy.codist
    sch = Schedules(*make_schedules(tc, codist))
    _, opt_update = make_optimizer(tc.optimizer, momentum=tc.momentum,
                                   b1=tc.adam_b1, b2=tc.adam_b2,
                                   dtype=tc.opt_dtype)
    accum = torch_dtype(tc.accum_dtype)

    def make_variant(variant: str) -> Callable:
        def step(state, batch_all: Dict):
            with on_mesh(state.params):
                operand = strategy.prepare(state, batch_all, tc.microbatch)

                def loss_fn(params, b):
                    total, metrics, aux = strategy.loss(
                        model, tc, sch, state, params, b, variant)
                    return total, (metrics, aux)

                grads, metrics, aux = _grads_metrics_aux(
                    loss_fn, state.params, operand, tc.microbatch, accum)
                lr, wd = sch.lr(state.step), sch.wd(state.step)
                params, opt = opt_update(state.params, grads, state.opt, lr,
                                         wd, trainable)
                metrics = plain_metrics(metrics)
            metrics.update(lr=lr, wd=wd)
            return strategy.post_update(state, params, opt, batch_all, aux,
                                        tc.microbatch), metrics
        return step

    variants = {v: make_variant(v) for v in strategy.variants}
    return StepBundle(strategy, variants, strategy.make_eval(model, tc))


# ----------------------------------------------------------------------------
# host-side exchange ops & eval steps
# ----------------------------------------------------------------------------

@torch.no_grad()
def refresh_stale(state: CodistState) -> CodistState:
    """The checkpoint exchange: stale <- current params (the cross-pod
    parameter all-gather in the sharded setting). Copies into the existing
    replicas in place; a state without them gets new ones."""
    if state.stale is None:
        return state._replace(stale=snapshot_params(state.params))
    for s, p in zip(tree_leaves(state.stale), tree_leaves(state.params)):
        s.copy_(p)
    return state

def make_eval_step(model, tc: Optional[TrainConfig] = None) -> Callable:
    fused = tc.fused_losses if tc is not None else None

    @torch.no_grad()
    def eval_step(params: PyTree, batch: Dict) -> Dict:
        logits, _ = _task_forward(model, params, batch, False)
        return {
            "eval_loss": cd.cross_entropy(logits, batch["labels"], 0.0,
                                          batch.get("mask"), fused=fused),
            "eval_accuracy": cd.accuracy(logits, batch["labels"],
                                         batch.get("mask")),
        }
    return eval_step


def make_codist_eval_step(model, tc: Optional[TrainConfig] = None) -> Callable:
    fused = tc.fused_losses if tc is not None else None

    @torch.no_grad()
    def eval_step(peer_params, batch_all: Dict) -> Dict:
        logits_all, _ = _stacked_forward(model, peer_params, batch_all, False)
        labels = batch_all["labels"]
        loss = torch.stack([cd.cross_entropy(lg, labels[i], fused=fused)
                            for i, lg in enumerate(logits_all)])
        acc = torch.stack([cd.accuracy(lg, labels[i])
                           for i, lg in enumerate(logits_all)])
        return {"eval_loss": loss.mean(), "eval_loss_per_model": loss,
                "eval_accuracy": acc.mean(), "eval_accuracy_per_model": acc}
    return eval_step
