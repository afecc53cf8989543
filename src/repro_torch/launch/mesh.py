"""The pod group: one process per codistilling model, joined by
``torch.distributed``.

The reference maps the n codistilling models onto a ``"pod"`` mesh axis of
one JAX process; the only collective crossing the (slow) pod-to-pod links is
the prediction exchange. The port runs one process per pod instead, each
holding only its own model, and ``PodGroup`` is that process's view of the
group: its rank (the pod index), the group's size, the device it computes
on and the process group it gathers over.

The group is made from a ``FileStore`` (a file in a temporary directory),
so parallel test workers never race for a TCP port. Without a mesh it uses
gloo, and every pod may share the one card: gloo's CUDA support covers
broadcast and all_reduce only, and NCCL refuses two ranks on one GPU, so
``PodGroup.all_gather`` stages through host memory there (a device-to-host
copy of the wire, gloo's CPU all_gather, a copy of each received wire back
to the device; on the CPU the copies are no-ops).

    pods = init_pod_group(n, rank, store_path, device="cuda")
    wires = pods.all_gather(wire)           # n tensors, in pod order

``spawn_pods(fn, n, ...)`` starts the n processes (``spawn``), makes each
one's group and calls ``fn(pods, *args)`` there; it returns the n results
and raises with a pod's traceback if any pod fails, the others killed.
Nothing falls back to one process: a group that cannot be made is an
error.

With a ``mesh`` (``spawn_pods(fn, mesh_chips(mesh), mesh=mesh)``) every
process is one device of the (pod, data, model) mesh, in its row-major
order: rank r computes on ``cuda:r`` (NCCL; a rank without its own card
fails) or on the CPU (gloo). ``device_mesh`` makes the ``torch.distributed``
``DeviceMesh`` of the same axes, and the rank's ``PodGroup`` is its pod
(``pod_index_of_device``) with the mesh's "pod" group, the ranks that hold
the same shard of every pod's peer: its ``all_gather`` of a DTensor sends
the local shard and re-wraps each received one with the placements it
left with, card to card under NCCL.

The production and dry-run meshes are here too, device-free: ``Mesh`` is a
frozen record of axis names and sizes whose device ids run row-major over
the axes, as ``jax.make_mesh`` lays out a slice. The sharding rules
(``launch/sharding.py``) and the cost model (``launch/cost.py``) read them;
``device_mesh`` turns one into a ``torch.distributed`` ``DeviceMesh``, on
which ``launch/sharding.py`` places a peer's state. The reference's
``set_mesh`` (an ambient mesh for ``jit``) has no counterpart: the port
passes the mesh to every function that reads it.

  single-pod:  (16, 16)      ("data", "model")         256 devices
  multi-pod:   (2, 16, 16)   ("pod", "data", "model")  512 devices

The ``"pod"`` axis is the codistillation axis: one model a pod, so the only
traffic across pods is the prediction exchange.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device


@dataclass
class PodGroup:
    """This process's place in the codistillation group: pod ``rank`` of
    ``size``, computing on ``device``, gathering over ``group`` (None: the
    default process group).

    The meter of the exchange: ``wire_bytes`` counts the bytes of the
    other pods' tensors that arrived through a metered ``all_gather`` (the
    prediction wire, not the metrics rows), ``wire_s`` the host seconds
    those gathers took from a synchronised device to the received tensors
    on it (the copies and the wait for the slowest pod included).

    On a mesh, ``mesh`` is the rank's ``DeviceMesh`` (axes "pod", "data",
    "model") and ``sub_mesh`` its pod's ("data", "model") part, on which
    the peer's state lives. A gathered DTensor's local shard is metered
    once a pod: by the rank whose coordinates are 0 along every mesh dim
    that replicates it, so that the pod's ranks sum to the bytes of the
    other pods' whole tensors (every replica receives them)."""
    rank: int
    size: int
    device: torch.device
    group: Any = None
    wire_bytes: int = 0
    wire_s: float = 0.0
    mesh: Any = None

    @property
    def sub_mesh(self):
        return None if self.mesh is None else self.mesh["data", "model"]

    def _gather(self, local: torch.Tensor) -> List[torch.Tensor]:
        """Every pod's ``local`` on this pod's device: NCCL gathers the
        device tensors, gloo stages them through host memory."""
        if dist.get_backend(self.group) == "nccl":
            local = local.contiguous()
            out = [torch.empty_like(local) for _ in range(self.size)]
            dist.all_gather(out, local, group=self.group)
            return out
        host = local.to("cpu").contiguous()
        out = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(out, host, group=self.group)
        return [o.to(self.device) for o in out]

    def all_gather(self, t: torch.Tensor,
                   meter: bool = False) -> List[torch.Tensor]:
        """Every pod's ``t`` (one shape and dtype on every pod), in pod
        order, on this pod's device; this pod's own entry is ``t``
        itself. A DTensor's local shard is what is sent, and each received
        shard comes back as a DTensor with ``t``'s mesh and placements."""
        if meter and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        from torch.distributed.tensor import DTensor
        placed = isinstance(t, DTensor)
        local = t.detach().to_local() if placed else t.detach()
        out = self._gather(local)
        if placed:
            out = [DTensor.from_local(o, t.device_mesh, t.placements,
                                      run_check=False, shape=t.shape,
                                      stride=t.stride()) for o in out]
        got = [t if r == self.rank else o for r, o in enumerate(out)]
        if meter:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.wire_s += time.perf_counter() - t0
            if not placed or _metering_replica(t):
                self.wire_bytes += ((self.size - 1) * local.numel()
                                    * local.element_size())
        return got


@dataclass
class ExpertExchange:
    """The meter of the expert all-to-all (``all_to_all``): ``bytes``
    counts the operand bytes a device sends into each exchange (its whole
    buffer, the block it keeps included, as ``launch/cost.py``
    ``CollectiveOp.operand_bytes`` counts an all-to-all), ``exchanges``
    the exchanges, forward and backward."""
    bytes: int = 0
    exchanges: int = 0

    def reset(self) -> None:
        self.bytes, self.exchanges = 0, 0


expert_exchange = ExpertExchange()


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    expert_exchange.bytes += x.numel() * x.element_size()
    expert_exchange.exchanges += 1
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with its gradient: the exchange is its own
    adjoint (block j of rank i becomes block i of rank j), so the backward
    sends the gradient back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (ways, ...) -> (ways, ...): block j of x goes to rank j of
    ``group`` (``ways`` ranks), block i of the result came from rank i;
    differentiable and metered (``expert_exchange``)."""
    if x.shape[0] != group.size():
        raise ValueError(f"{x.shape[0]} blocks for a group of "
                         f"{group.size()}")
    return _AllToAll.apply(x, group)


def _metering_replica(t) -> bool:
    """Whether this rank holds the metered copy of a DTensor's local shard:
    its coordinate is 0 along every mesh dim that does not shard ``t``."""
    from torch.distributed.tensor import Shard
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, t.placements)
               if not isinstance(p, Shard))


def init_pod_group(n: int, rank: int, store_path: str, backend: str = "gloo",
                   device="cuda", timeout_s: float = 300.0) -> PodGroup:
    """Join the n-process group as ``rank`` through the ``FileStore`` at
    ``store_path`` (a file that does not exist yet, or that the other ranks
    share) and return this pod's ``PodGroup``."""
    dev = resolve_device(device)
    store = dist.FileStore(store_path, n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=timedelta(seconds=timeout_s))
    return PodGroup(dist.get_rank(), n, dev)


def device_mesh(mesh: "Mesh", device_type: str):
    """The ``torch.distributed`` ``DeviceMesh`` of ``mesh`` (its axis names
    and sizes, ranks in its row-major order ``Mesh.devices``) over the
    default process group, whose size must be ``mesh_chips(mesh)``."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world != mesh_chips(mesh):
        raise ValueError(f"a mesh of {mesh_chips(mesh)} devices "
                         f"{mesh.shape} over {world} ranks")
    dm = init_device_mesh(device_type, mesh.axis_sizes,
                          mesh_dim_names=mesh.axis_names)
    if dm.mesh.tolist() != mesh.devices.tolist():
        raise RuntimeError(f"device mesh ranks {dm.mesh.tolist()} are not "
                           f"the row-major {mesh.devices.tolist()}")
    return dm


def mesh_pod_group(mesh: "Mesh", dm, device) -> PodGroup:
    """This rank's ``PodGroup`` on the device mesh ``dm`` of ``mesh``: its
    pod, the pod axis's size and group."""
    rank = dist.get_rank()
    return PodGroup(pod_index_of_device(mesh, rank), mesh.shape["pod"],
                    torch.device(device), dm.get_group("pod"), mesh=dm)


def rank_device(device, rank: int) -> torch.device:
    """The device of mesh rank ``rank``: ``cuda:rank``, which must exist
    (no rank falls back to another card or to the CPU), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if rank >= torch.cuda.device_count():
        raise RuntimeError(f"mesh rank {rank} needs its own card, and this "
                           f"host has {torch.cuda.device_count()}")
    return torch.device("cuda", rank)


def init_mesh_group(mesh: "Mesh", rank: int, store_path: str, device="cuda",
                    timeout_s: float = 300.0) -> PodGroup:
    """Join the ``mesh_chips(mesh)``-process group as ``rank`` (NCCL on the
    rank's own card, gloo on the CPU) and return its ``PodGroup`` on the
    mesh."""
    dev = rank_device(device, rank)
    n = mesh_chips(mesh)
    store = dist.FileStore(store_path, n)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=store, rank=rank, world_size=n,
                                timeout=timedelta(seconds=timeout_s),
                                device_id=dev)
    else:
        dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                                timeout=timedelta(seconds=timeout_s))
    return mesh_pod_group(mesh, device_mesh(mesh, dev.type), dev)


def _pod_main(fn, rank: int, n: int, store_path: str, device: str,
              threads: int, args: Sequence, results, mesh=None) -> None:
    """One spawned pod (or mesh rank): make its group, run ``fn``, report
    to the parent. On the CPU the processes share the cores: each takes its
    share of the parent's intra-op threads."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, threads // n))
    try:
        pods = (init_pod_group(n, rank, store_path, device=device)
                if mesh is None else
                init_mesh_group(mesh, rank, store_path, device=device))
        try:
            results.put((rank, True, fn(pods, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_pods(fn: Callable, n: int, args: Sequence = (), device="cuda",
               timeout_s: float = 1800.0, *, mesh: "Mesh" = None) -> list:
    """Run ``fn(pods, *args)`` in n spawned processes, one pod each, and
    return their results in pod order, every pod on ``device`` (the card
    unless the caller asks for the CPU). ``fn`` and ``args`` are pickled
    (``fn`` by its import path). A pod that raises, or dies, or a run past
    ``timeout_s`` raises here with what is known, every pod stopped.

    With a ``mesh`` the n = ``mesh_chips(mesh)`` processes are its ranks
    (``init_mesh_group``: rank r on ``cuda:r``), the results in rank
    order."""
    if mesh is not None and n != mesh_chips(mesh):
        raise ValueError(f"{n} processes for a mesh of {mesh_chips(mesh)}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="pods-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_pod_main,
                             args=(fn, r, n, store, str(device),
                                   torch.get_num_threads(), tuple(args),
                                   results, mesh))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout_s
            while len(out) < n:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead and not results.empty():
                        continue          # its report is still in the pipe
                    if dead:
                        raise RuntimeError(f"pods {dead} exited with codes "
                                           f"{[procs[r].exitcode for r in dead]}"
                                           " without a result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"pods still running after "
                                           f"{timeout_s:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"pod {rank} of {n} failed:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join(timeout=60.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [out[r] for r in range(n)]


# ----------------------------------------------------------------------------
# device-free meshes (the reference's production and dry-run meshes)
# ----------------------------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; device ``i`` sits at the row-major position
    ``i`` of the axes (``devices`` holds the ids in that layout)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} vs {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (``jax``'s ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes, dtype=np.int64))

    @property
    def devices(self) -> np.ndarray:
        """The device ids, shaped by the axes (row-major)."""
        return np.arange(self.size).reshape(self.axis_sizes)

    def groups(self, axes) -> List[List[int]]:
        """The device groups of a collective over ``axes`` (a name or a
        tuple of names): the devices whose coordinates differ only along
        those axes, each group in row-major order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        ids = self.devices.transpose(rest + idx)
        return ids.reshape(-1, int(np.prod([self.axis_sizes[i] for i in idx],
                                           dtype=np.int64))).tolist()


def logical_mesh(dm) -> Mesh:
    """The ``Mesh`` (axis names and sizes) of a ``DeviceMesh``."""
    return abstract_mesh(dm.mesh.shape, dm.mesh_dim_names)


def abstract_mesh(axis_sizes, axis_names) -> Mesh:
    """A device-free mesh for the sharding rules (the reference's
    ``AbstractMesh``)."""
    return Mesh(tuple(int(a) for a in axis_sizes), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_codist_mesh(n_models: int = 2, data: int = 8,
                     model: int = 16) -> Mesh:
    """One pod's devices split into n_models groups (the paper's "8 GPUs a
    model on one server" analogue)."""
    return Mesh((n_models, data, model), ("pod", "data", "model"))


def make_host_mesh(shape=(2, 2, 2), axes=("pod", "data", "model")) -> Mesh:
    """A tiny mesh for CI-scale rules and collectives (8 devices)."""
    return Mesh(tuple(shape), tuple(axes))


def mesh_chips(mesh: Mesh) -> int:
    return mesh.size


def pod_index_of_device(mesh: Mesh, device_id: int) -> int:
    """Which pod a flat device id belongs to (0 without a pod axis or for
    an id outside the mesh)."""
    if "pod" not in mesh.axis_names or not 0 <= device_id < mesh.size:
        return 0
    coord = np.unravel_index(device_id, mesh.axis_sizes)
    return int(coord[mesh.axis_names.index("pod")])
