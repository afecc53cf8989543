"""Codistillation (Algorithm 1): the task and distillation losses and the
combined loss over n peers.

The n codistilling models are a LIST of parameter trees, one per peer (the
reference stacks them on a leading axis for vmap and pod sharding; the
port's forward loops over peers instead, and a list keeps each peer's
tensors its own leaves for autograd and the in-place optimizer).
``stack_models`` / ``model_slice`` convert to and from the stacked layout.

The total loss of one step is

    L = (1/n) sum_i [ task(f_i(x_i), y_i)
                      + alpha/(n-1) sum_{j!=i} D(f_i(x_i), sg(f_j(x_i))) ]

With coordinated sampling every peer sees the same batch, and detaching
the targets makes one backward pass compute the Algorithm-1 update of all
peers at once.

Loss math dispatches through the ``fused`` flag: None => on for CUDA
tensors (the fused loss kernels of ``repro_torch.kernels.ops``), off on the
CPU. With it on, each peer's task CE and first distillation term come from
ONE combined kernel call (``fused_ce_distill``) when the first peer's wire
is full width; every further term (a third peer on) and a subsampled
wire's term come from the standalone distillation kernels
(``fused_distill_mean``); the off-step and eval CE from
``fused_cross_entropy_loss``. The top-k wire's loss is plain torch, as the
reference's is jnp only. The unfused paths are the reference's own jnp
losses, as plain torch.

The wires are ``none``, ``bf16``, ``topk`` (an exact top-k whose ties go
to the lowest index, as ``jax.lax.top_k``) and ``subsample``.

The pod-local paths (the reference's shard_map over a ``"pod"`` mesh axis)
run one process per model, joined in a ``PodGroup``
(``repro_torch.launch.mesh``): each pod compresses its own logits and the
ONLY collective is the all-gather of that wire (``gather_wire``, the top-k
indices sent as int32). ``codist_loss`` with a ``pods`` group is the
function ``ShardMapCompressed`` calls: under the reference's gate (a top-k
wire, live predictions, n > 1) it takes ``podlocal_codist_terms``, one
pod's task CE and mean distillation against the other pods' wires, and
otherwise distills this pod's logits against the gathered wires
(``_compress_stacked``'s pod-local branch) through the peer terms of the
single-process loss, the combined kernel included.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import CodistConfig
from repro_torch.kernels.ops import (fused_losses_default, is_dtensor,
                                     local_device, whole)
from repro_torch.models.sharding_hints import hint
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

def _fused_enabled(fused: Optional[bool], x: torch.Tensor) -> bool:
    """The flag, or by default whether ``x``'s values (a DTensor's local
    shard's) are on the card."""
    if fused is None:
        return fused_losses_default(local_device(x))
    return bool(fused)


def _masked(per_tok: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The masked mean (a whole value on every rank of a DTensor's mesh)."""
    if mask is not None:
        mask = mask.float()
        return whole((per_tok * mask).sum()
                     / torch.clamp(whole(mask.sum()), min=1.0))
    return whole(per_tok.mean())


# ----------------------------------------------------------------------------
# task losses
# ----------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing=0.0, mask: Optional[torch.Tensor] = None,
                  fused: Optional[bool] = None) -> torch.Tensor:
    """Mean token-level CE with optional label smoothing and validity mask.

    logits (..., V) float; labels (...) int; mask (...) broadcastable."""
    if _fused_enabled(fused, logits):
        from repro_torch.kernels.ops import fused_cross_entropy_loss
        return fused_cross_entropy_loss(logits, labels, label_smoothing, mask)
    logits = logits.float()
    v = logits.shape[-1]
    logz = torch.logsumexp(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), v).to(logits.dtype)
    true_logit = (logits * onehot).sum(dim=-1)
    nll = logz - true_logit
    ls = torch.as_tensor(label_smoothing, dtype=torch.float32,
                         device=logits.device)
    smooth = logz - logits.mean(dim=-1)
    return _masked((1.0 - ls) * nll + ls * smooth, mask)


def _vocab_whole(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a DTensor ``x`` with its last dim gathered on every rank."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == last else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Argmax over the full (padded) vocab width, as the reference's (on a
    DTensor, over V gathered whole on each rank)."""
    correct = (_vocab_whole(logits).argmax(dim=-1) == labels).float()
    return _masked(correct, mask)


# ----------------------------------------------------------------------------
# distillation losses D(y, y')   (paper: MSE between UNCENTERED logits, A.3)
# ----------------------------------------------------------------------------

def distill_mse(logits: torch.Tensor, target_logits: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                fused: Optional[bool] = None) -> torch.Tensor:
    """Mean squared error between logits — the paper's D."""
    if _fused_enabled(fused, logits):
        from repro_torch.kernels.ops import fused_distill_mean
        return fused_distill_mean(logits, target_logits, "mse", mask)
    d = (logits.float() - target_logits.float()) ** 2
    return _masked(d.mean(dim=-1), mask)


def distill_kl(logits: torch.Tensor, target_logits: torch.Tensor,
               mask: Optional[torch.Tensor] = None, temperature: float = 1.0,
               fused: Optional[bool] = None) -> torch.Tensor:
    """KL(softmax(target) || softmax(logits)) — Zhang et al. / Anil et al."""
    if temperature == 1.0 and _fused_enabled(fused, logits):
        from repro_torch.kernels.ops import fused_distill_mean
        return fused_distill_mean(logits, target_logits, "kl", mask)
    lt = target_logits.float() / temperature
    ls = logits.float() / temperature
    p = torch.softmax(lt, dim=-1)
    per_tok = (p * (torch.log_softmax(lt, dim=-1)
                    - torch.log_softmax(ls, dim=-1))).sum(dim=-1)
    return _masked(per_tok, mask)


def distill_ce(logits: torch.Tensor, target_logits: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft cross-entropy against the peer's softmax (plain torch only, as
    the reference's is jnp only)."""
    p = torch.softmax(target_logits.float(), dim=-1)
    per_tok = -(p * torch.log_softmax(logits.float(), dim=-1)).sum(dim=-1)
    return _masked(per_tok, mask)


_DISTILL = {"mse": distill_mse, "kl": distill_kl, "ce": distill_ce}


def distill_pair(kind: str, logits: torch.Tensor, target_logits: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 fused: Optional[bool] = None) -> torch.Tensor:
    if kind in ("mse", "kl"):
        return _DISTILL[kind](logits, target_logits, mask, fused=fused)
    return _DISTILL[kind](logits, target_logits, mask)


# ----------------------------------------------------------------------------
# compressed prediction exchange
# ----------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, in
    descending order, ties to the lowest index: ``jax.lax.top_k``'s order
    (``torch.topk`` does not fix the order of equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _hierarchical_topk(x: torch.Tensor, k: int, segments: int = 16):
    """Exact top-k via per-segment top-k + top-k of the candidate union, as
    the reference (there it keeps the vocab axis sharded). Every global
    top-k element is in its segment's top-k, and the candidates keep
    segment order, so ties still go to the lowest index."""
    *lead, v = x.shape
    if v % segments or v // segments < k:
        return _top_k(x, k)
    seg = v // segments
    xs = hint(x.reshape(*lead, segments, seg), "wire")
    lv, li = _top_k(xs, k)                                 # (..., segments, k)
    lv, li = hint(lv, "wire"), hint(li, "wire")
    li = li + (torch.arange(segments, device=x.device) * seg)[:, None]
    lv = lv.reshape(*lead, segments * k)
    li = li.reshape(*lead, segments * k)
    gv, gi = _top_k(hint(lv, "wire"), k)
    return hint(gv, "wire"), hint(li.gather(-1, gi), "wire")


def _subsample_stride(cfg: CodistConfig, full_seq: int) -> int:
    return max(1, full_seq // cfg.subsample)


def compress_targets(cfg: CodistConfig, target_logits: torch.Tensor) -> Dict:
    """The wire a peer sends: its logits, their bf16 rounding, their top-k
    (values and int64 indices), or a strided subset of their tokens along
    the sequence axis (axis -2 of (B, S, V)). A subsample count of 0 sends
    the logits, as the reference does."""
    if cfg.compression == "bf16":
        return {"vals": target_logits.to(torch.bfloat16)}
    if cfg.compression == "topk":
        vals, idx = _hierarchical_topk(target_logits, cfg.topk)
        return {"vals": vals, "idx": idx}
    if cfg.compression == "subsample" and cfg.subsample:
        stride = _subsample_stride(cfg, target_logits.shape[-2])
        return {"vals": target_logits[..., ::stride, :][..., :cfg.subsample, :]}
    return {"vals": target_logits}


def gather_wire(wire: Dict, pods) -> List[Dict]:
    """Every pod's wire, in pod order, through ``pods.all_gather`` (the one
    collective of the exchange, metered there): each leaf in a sorted key
    order, int64 top-k indices sent as int32 (a vocab fits) and widened on
    receipt."""
    out: List[Dict] = [{} for _ in range(pods.size)]
    for key in sorted(wire):
        x = wire[key].detach()
        sent = x.to(torch.int32) if x.dtype == torch.int64 else x
        for r, got in enumerate(pods.all_gather(sent, meter=True)):
            out[r][key] = got.to(x.dtype)
    return out


def _compress_stacked(cfg: CodistConfig, targets: Sequence[torch.Tensor],
                      pods=None) -> List[Dict]:
    """The wires of the peers' ``targets``. Pod-local with ``pods``:
    ``targets`` holds this pod's logits alone, compressed here, and the
    other pods' wires arrive through ``gather_wire``."""
    if pods is not None:
        return gather_wire(compress_targets(cfg, targets[0].detach()), pods)
    return [compress_targets(cfg, t.detach()) for t in targets]


def pod_rows(pods, row: torch.Tensor) -> torch.Tensor:
    """(n, *row.shape): every pod's ``row`` in pod order, this pod's entry
    the given tensor (its gradient kept), the others' gathered values."""
    row = whole(row)
    rows = pods.all_gather(row.detach())
    rows[pods.rank] = row
    return torch.stack(rows)


def podlocal_codist_terms(cfg: CodistConfig, pods, logits: torch.Tensor,
                          labels: torch.Tensor, label_smoothing=0.0,
                          mask: Optional[torch.Tensor] = None,
                          fused: Optional[bool] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(task, distill) of this pod's model: its task CE, the wire of its
    detached logits gathered from every pod (the only cross-pod
    communication), and the mean distillation term against the other n - 1
    pods' wires. The reference's ``_podlocal_codist_terms`` per pod."""
    task = cross_entropy(logits, labels, label_smoothing, mask, fused=fused)
    wires = _compress_stacked(cfg, [logits], pods)
    terms = [distill_vs_compressed(cfg, logits, w, mask, fused=fused)
             for j, w in enumerate(wires) if j != pods.rank]
    dist = (sum(terms) / (pods.size - 1) if terms
            else torch.zeros((), dtype=torch.float32, device=task.device))
    return task, dist


def distill_vs_compressed(cfg: CodistConfig, logits: torch.Tensor, wire: Dict,
                          mask: Optional[torch.Tensor] = None,
                          fused: Optional[bool] = None) -> torch.Tensor:
    kind = cfg.compression
    if kind == "subsample" and not cfg.subsample:
        kind = "none"
    if kind in ("none", "bf16"):
        # full-vocab-width targets: the fused distillation kernels apply
        return distill_pair(cfg.distill_loss, logits, wire["vals"], mask,
                            fused=fused)
    if kind == "topk":
        own = logits.gather(-1, wire["idx"]).float()
        vals = wire["vals"].float()
        if cfg.distill_loss == "mse":
            per_tok = ((own - vals) ** 2).mean(dim=-1)
        else:  # renormalized soft-CE over the top-k support
            p = torch.softmax(vals, dim=-1)
            per_tok = -(p * torch.log_softmax(own, dim=-1)).sum(dim=-1)
        return _masked(per_tok, mask)
    if kind == "subsample":
        stride = _subsample_stride(cfg, logits.shape[-2])
        k = wire["vals"].shape[-2]
        own = logits[..., ::stride, :][..., :k, :]
        sub_mask = None if mask is None else mask[..., ::stride][..., :k]
        # subsampled tokens keep the full vocab width: the kernels apply
        return distill_pair(cfg.distill_loss, own, wire["vals"], sub_mask,
                            fused=fused)
    raise ValueError(f"unknown compression {cfg.compression!r}")


# ----------------------------------------------------------------------------
# Algorithm 1: the combined codistillation loss over the peers' logits
# ----------------------------------------------------------------------------

def _peer_terms(cfg: CodistConfig, logits: torch.Tensor,
                labels: torch.Tensor, wires: List[Dict], label_smoothing,
                mask: Optional[torch.Tensor], use_fused: bool):
    """(task, mean distillation over ``wires``) of one peer. Hot path: the
    task CE fused with the first distillation term (one sweep of the
    student logits, the combined kernel); further terms from the
    standalone distillation kernels."""
    combined = (use_fused and wires and cfg.distill_loss in ("mse", "kl")
                and set(wires[0]) == {"vals"}
                and wires[0]["vals"].shape == logits.shape)
    if combined:
        from repro_torch.kernels.ops import fused_ce_distill
        task, d0 = fused_ce_distill(logits, wires[0]["vals"], labels,
                                    mode=cfg.distill_loss,
                                    label_smoothing=label_smoothing, mask=mask)
        terms = [d0] + [distill_vs_compressed(cfg, logits, w, mask,
                                              fused=use_fused)
                        for w in wires[1:]]
    else:
        task = cross_entropy(logits, labels, label_smoothing, mask,
                             fused=use_fused)
        terms = [distill_vs_compressed(cfg, logits, w, mask, fused=use_fused)
                 for w in wires]
    dist = (sum(terms) / len(terms) if terms
            else torch.zeros((), dtype=torch.float32, device=task.device))
    return task, dist


def codist_loss(cfg: CodistConfig,
                logits_all: Sequence[torch.Tensor],   # n x (..., V)
                labels_all: torch.Tensor,             # (n, ...)
                alpha, label_smoothing=0.0,
                mask_all: Optional[torch.Tensor] = None,
                peer_logits_all: Optional[Sequence[torch.Tensor]] = None,
                peer_pairwise=None,
                fused: Optional[bool] = None,
                pods=None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean over peers of (task + alpha * mean_peers D(own, sg(peer))).

    ``logits_all`` is a sequence of the n peers' logits (a list, or a
    stacked tensor). ``peer_logits_all`` overrides the targets (pipelined
    exchange: the previous step's logits); ``peer_pairwise[i][j]`` is peer
    j's prediction on peer i's batch (checkpoint mode, where each peer
    evaluates the stale replicas on its own batch; a nested list whose
    diagonal is never read, or an (n, n, ...) tensor). Default is the live
    logits (prediction mode with coordinated sampling). With ``fused`` on
    and a full-width first peer wire, each peer's task CE and first
    distillation term come from the combined kernel; further terms from
    the standalone distillation kernels.

    With a ``pods`` group (one process per model, ``launch/mesh.py``) the
    sequences hold this pod's entry alone and the per-model metrics are
    gathered from every pod, this pod's row keeping its gradient: a top-k
    wire of live predictions (n > 1) takes ``podlocal_codist_terms``, as
    the reference pins its shard_map schedule; any other wire distills
    this pod's logits against the gathered wires."""
    targets = peer_logits_all if peer_logits_all is not None else logits_all
    use_fused = len(logits_all) > 0 and _fused_enabled(fused, logits_all[0])
    if pods is not None:
        m0 = None if mask_all is None else mask_all[0]
        if (cfg.compression == "topk" and peer_logits_all is None
                and peer_pairwise is None and pods.size > 1):
            task_i, dist_i = podlocal_codist_terms(
                cfg, pods, logits_all[0], labels_all[0], label_smoothing, m0,
                fused=use_fused)
        else:
            wires = _compress_stacked(cfg, targets, pods)
            task_i, dist_i = _peer_terms(
                cfg, logits_all[0], labels_all[0],
                [w for j, w in enumerate(wires) if j != pods.rank],
                label_smoothing, m0, use_fused)
        rows = pod_rows(pods, torch.stack([task_i, dist_i]))
        task, dist = rows[:, 0], rows[:, 1]
    else:
        n = len(logits_all)
        if peer_pairwise is None:
            wires_all = _compress_stacked(cfg, targets)
        task_losses: List[torch.Tensor] = []
        distill_losses: List[torch.Tensor] = []
        for i in range(n):
            if peer_pairwise is not None:
                wires_i = [compress_targets(cfg, peer_pairwise[i][j].detach())
                           for j in range(n) if j != i]
            else:
                wires_i = [wires_all[j] for j in range(n) if j != i]
            task_i, dist_i = _peer_terms(
                cfg, logits_all[i], labels_all[i], wires_i, label_smoothing,
                None if mask_all is None else mask_all[i], use_fused)
            task_losses.append(task_i)
            distill_losses.append(dist_i)
        task = torch.stack(task_losses)
        dist = torch.stack(distill_losses)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=task.device)
    total = (task + alpha * dist).mean()
    metrics = {
        "loss": total,
        "task_loss": task.mean(),
        "distill_loss": dist.mean(),
        "task_loss_per_model": task,
        "distill_loss_per_model": dist,
        "alpha": alpha,
    }
    return total, metrics


# ----------------------------------------------------------------------------
# peer-tree helpers
# ----------------------------------------------------------------------------

def init_stacked(init_fn: Callable[..., PyTree], generator: torch.Generator,
                 n: int, **kw) -> List[PyTree]:
    """n independent inits, drawn one after another from ``generator``: a
    list of n parameter trees (the reference stacks them)."""
    return [init_fn(generator, **kw) for _ in range(n)]


def model_slice(stacked: PyTree, i: int) -> PyTree:
    """Peer i of a stacked tree (leading peer axis), as views."""
    return tree_map(lambda x: x[i], stacked)


def stack_models(trees: List[PyTree]) -> PyTree:
    """A list of peer trees -> one tree with a leading peer axis."""
    return tree_map(lambda *xs: torch.stack([x.detach() for x in xs]), *trees)


@torch.no_grad()
def param_distance_from(params: PyTree, ref: PyTree) -> torch.Tensor:
    """||theta - theta_0||_2 (the Fig. 7 regularization-effect study)."""
    sq = [((a.float() - b.float()) ** 2).sum()
          for a, b in zip(tree_leaves(params), tree_leaves(ref))]
    return torch.sqrt(torch.stack(sq).sum())
