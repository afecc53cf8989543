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
error. The reference's TPU meshes (the production and dry-run meshes)
are not here.
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
from typing import Any, Callable, List, Sequence

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
    return make_codist_mesh(n, dev)


def make_codist_mesh(n_models: int, device="cuda") -> PodGroup:
    """This process's pod of the initialised default process group, which
    must hold one process per model (the reference's ``("pod",)`` axis of
    size n_models)."""
    if not dist.is_initialized():
        raise RuntimeError("make_codist_mesh needs an initialised process "
                           "group (init_pod_group)")
    size = dist.get_world_size()
    if size != n_models:
        raise ValueError(f"the process group has {size} processes; the "
                         f"codistillation group needs one per model "
                         f"({n_models})")
    return PodGroup(dist.get_rank(), size, resolve_device(device))


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
