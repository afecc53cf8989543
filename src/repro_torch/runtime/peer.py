"""One virtual peer: its train state, local step clock, burn-in gate, and
checkpoint-based recovery.

Every peer drives the SAME step functions (one ``StepBundle`` of the
``AsyncPrediction`` strategy); peers differ only in their ``TrainState``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.checkpoint.io import has_snapshot, load_snapshot, save_snapshot
from repro_torch.train.loop import History
from repro_torch.train.state import TrainState, trainable_params


class PeerRuntime:
    """Host-side bookkeeping for one codistilling peer on its own clock."""

    def __init__(self, pid: int, state: TrainState, *, burn_in: int = 0,
                 joined_at: float = 0.0):
        self.pid = pid
        self.state = state
        self.step = int(state.step)          # local step (mirrors state.step)
        self.alive = True
        self.finished = False
        self.burn_in = burn_in               # local steps before distilling
        self.joined_at = joined_at
        self.completed_at: Optional[float] = None
        self.hist = History()

    @property
    def distill_ready(self) -> bool:
        """Burn-in gate (the paper / Anil et al.): a freshly joined peer
        neither distills nor publishes until it has trained ``burn_in``
        local steps — random predictions would poison the cluster."""
        return self.step >= self.burn_in

    def advance(self, new_state: TrainState) -> None:
        self.state = new_state
        self.step += 1

    def die(self) -> None:
        self.alive = False

    # ---- checkpoint-based recovery -----------------------------------------
    def snapshot(self, directory: str) -> None:
        # the step in the meta lets a reader order snapshots without
        # loading their payloads
        save_snapshot(directory, self.pid, self.state,
                      meta={"step": self.step})

    def can_recover(self, directory: Optional[str]) -> bool:
        return directory is not None and has_snapshot(directory, self.pid)

    def restore(self, directory: str, rejoined_at: float) -> None:
        """Rejoin from the last snapshot: params, optimizer state and step
        all rewind to it, so the peer replays the lost steps (and its
        mailbox payloads resume from there). The restored tensors take the
        current state's devices and dtypes."""
        state = load_snapshot(directory, self.pid, self.state)
        self.state = state._replace(params=trainable_params(state.params))
        self.step = int(self.state.step)
        self.alive = True
        self.joined_at = rejoined_at
