"""Asynchronous fault-tolerant peer runtime (deterministic virtual cluster).

N codistilling peers on independent step clocks over a seeded simulated
timeline — speed heterogeneity, straggler episodes, preemption, permanent
failure with checkpoint recovery, and elastic membership — with
predictions flowing through a timestamped mailbox under a staleness-bound
policy. The reference's ``repro.runtime``, with every peer on the card.
"""
from repro_torch.runtime.clock import (  # noqa: F401
    FaultConfig,
    FaultSchedule,
    VirtualClock,
    parse_faults,
)
from repro_torch.runtime.mailbox import (  # noqa: F401
    Mailbox,
    Payload,
    StalenessStats,
)
from repro_torch.runtime.peer import PeerRuntime  # noqa: F401
from repro_torch.runtime.scheduler import (  # noqa: F401
    AsyncScheduler,
    RunReport,
    simulate_allreduce,
)
