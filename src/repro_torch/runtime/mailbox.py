"""Timestamped peer-to-peer payload store with measured staleness.

In the synchronous engine the prediction exchange happens inside one step;
in the async runtime peers run on independent step clocks, so predictions
flow through this host-side ``Mailbox`` instead. Every payload carries the
sender's local step and the simulated post time; the consumer side applies
the **staleness-bound policy** of the paper's tolerance discussion:

  * ``bound=None``   keep-last: always distill against the newest payload,
                     however old;
  * ``bound=S``      drop: a payload older than ``S`` receiver-steps
                     contributes nothing (weight 0) — ``S=0`` accepts only
                     same-step payloads, reproducing the synchronous
                     prediction exchange exactly.

The payloads are the producers' wire tensors and stay on their device: the
mailbox holds references, never host copies. It meters the bytes that
would cross the slow links: a posted payload costs its bytes (``numel x
element_size`` over the wire's tensors) once per consumer that actually
receives it; re-reading a cached keep-last payload on later steps is free,
as the receiver already holds it. The reference's logic, with torch wires.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.tree import tree_leaves

PyTree = Any


def payload_bytes(payload: PyTree) -> int:
    return int(sum(x.numel() * x.element_size()
                   for x in tree_leaves(payload)))


@dataclass
class Payload:
    sender: int
    step: int          # sender's local step when posted
    time: float        # simulated post time
    data: PyTree


@dataclass
class StalenessStats:
    """Measured receiver_step - sender_step over accepted / offered payloads."""
    accepted: int = 0
    dropped: int = 0
    total: float = 0.0
    max: float = 0.0

    def record(self, staleness: float, ok: bool) -> None:
        if ok:
            self.accepted += 1
            self.total += staleness
            self.max = max(self.max, staleness)
        else:
            self.dropped += 1

    @property
    def mean(self) -> float:
        return self.total / self.accepted if self.accepted else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"staleness_mean": self.mean, "staleness_max": self.max,
                "payloads_accepted": self.accepted,
                "payloads_dropped": self.dropped}


class Mailbox:
    """Keep-last store of per-sender payloads, one slot per (sender, kind)."""

    def __init__(self, staleness_bound: Optional[int] = None):
        self.staleness_bound = staleness_bound
        self._slots: Dict[Tuple[int, str], Payload] = {}
        # (receiver, sender, kind) -> sender step last transferred, so a
        # keep-last payload re-read across several receiver steps is billed
        # only for the one transfer that physically happened
        self._delivered: Dict[Tuple[int, int, str], int] = {}
        self.stats = StalenessStats()
        self.bytes_posted = 0
        self.bytes_delivered = 0

    def post(self, sender: int, step: int, time: float, data: PyTree,
             kind: str = "predictions") -> None:
        self._slots[(sender, kind)] = Payload(sender, step, time, data)
        self.bytes_posted += payload_bytes(data)

    def peek(self, sender: int, kind: str = "predictions"
             ) -> Optional[Payload]:
        return self._slots.get((sender, kind))

    def drop_peer(self, sender: int) -> None:
        """Forget a failed peer's payloads: its predictions must not keep
        feeding the cluster after it is gone (and their device memory is
        released once no operand holds them)."""
        for key in [k for k in self._slots if k[0] == sender]:
            del self._slots[key]

    def collect(self, receiver: int, receiver_step: int,
                senders: List[int], kind: str = "predictions"
                ) -> List[Tuple[int, Optional[Payload], float]]:
        """For each sender, the freshest payload and its acceptance weight.

        Returns ``[(sender, payload_or_None, weight)]``; weight is 0.0 when
        no payload exists or the drop policy rejects it (older than the
        bound in receiver steps). Accepted deliveries are metered as bytes
        crossing the slow links and their staleness recorded.
        """
        out: List[Tuple[int, Optional[Payload], float]] = []
        for s in senders:
            if s == receiver:
                continue
            p = self._slots.get((s, kind))
            if p is None:
                out.append((s, None, 0.0))
                continue
            staleness = float(receiver_step - p.step)
            ok = (self.staleness_bound is None
                  or staleness <= self.staleness_bound)
            self.stats.record(max(staleness, 0.0), ok)
            if ok and self._delivered.get((receiver, s, kind)) != p.step:
                self._delivered[(receiver, s, kind)] = p.step
                self.bytes_delivered += payload_bytes(p.data)
            out.append((s, p if ok else None, 1.0 if ok else 0.0))
        return out
