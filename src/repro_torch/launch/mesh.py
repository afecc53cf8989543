"""The pod group: one process per codistilling model, joined by
``torch.distributed``.

The reference maps the n codistilling models onto a ``"pod"`` mesh axis of
one JAX process; the only collective crossing the (slow) pod-to-pod links is
the prediction exchange. The port runs one process per pod instead, each
holding only its own model, and ``PodGroup`` is that process's view of the
group: its rank (the pod index), the group's size, the device it computes
on and the process group it gathers over.

The group is made from a ``FileStore`` (a file in a temporary directory),
so parallel test workers never race for a TCP port, and uses gloo. Gloo's
CUDA support covers broadcast and all_reduce only, and NCCL refuses two
ranks on one GPU, so ``PodGroup.all_gather`` stages through host memory:
a device-to-host copy of the wire, gloo's CPU all_gather, and a copy of
each received wire back to the device. On the CPU the copies are no-ops.

    pods = init_pod_group(n, rank, store_path, device="cuda")
    wires = pods.all_gather(wire)           # n tensors, in pod order

``spawn_pods(fn, n, ...)`` starts the n processes (``spawn``), makes each
one's group and calls ``fn(pods, *args)`` there; it returns the n results
and raises with a pod's traceback if any pod fails, the others killed.
Nothing falls back to one process: a group that cannot be made is an
error.

The production and dry-run meshes are here too, device-free: ``Mesh`` is a
frozen record of axis names and sizes whose device ids run row-major over
the axes, as ``jax.make_mesh`` lays out a slice. The sharding rules
(``launch/sharding.py``) and the cost model (``launch/cost.py``) read them;
nothing is placed on a device (the rules' execution on a
``torch.distributed`` ``DeviceMesh`` is a later step). The reference's
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
    on it (the copies and the wait for the slowest pod included)."""
    rank: int
    size: int
    device: torch.device
    group: Any = None
    wire_bytes: int = 0
    wire_s: float = 0.0

    def all_gather(self, t: torch.Tensor,
                   meter: bool = False) -> List[torch.Tensor]:
        """Every pod's ``t`` (one shape and dtype on every pod), in pod
        order, on this pod's device; this pod's own entry is ``t``
        itself. Staged through host memory (module docstring)."""
        if meter and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        host = t.detach().to("cpu").contiguous()
        out = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(out, host, group=self.group)
        got = [t if r == self.rank else o.to(self.device)
               for r, o in enumerate(out)]
        if meter:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.wire_s += time.perf_counter() - t0
            self.wire_bytes += (self.size - 1) * host.numel() * host.element_size()
        return got


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


def _pod_main(fn, rank: int, n: int, store_path: str, device: str,
              threads: int, args: Sequence, results) -> None:
    """One spawned pod: make its group, run ``fn``, report to the parent.
    On the CPU the pods share the cores: each takes its share of the
    parent's intra-op threads."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, threads // n))
    try:
        pods = init_pod_group(n, rank, store_path, device=device)
        try:
            results.put((rank, True, fn(pods, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_pods(fn: Callable, n: int, args: Sequence = (), device="cuda",
               timeout_s: float = 1800.0) -> list:
    """Run ``fn(pods, *args)`` in n spawned processes, one pod each, and
    return their results in pod order, every pod on ``device`` (the card
    unless the caller asks for the CPU). ``fn`` and ``args`` are pickled
    (``fn`` by its import path). A pod that raises, or dies, or a run past
    ``timeout_s`` raises here with what is known, every pod stopped."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="pods-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_pod_main,
                             args=(fn, r, n, store, str(device),
                                   torch.get_num_threads(), tuple(args),
                                   results))
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
