"""Continuous-batching serving fleet over codistilled peers, on the paged
KV pool.

    workload.py   seeded open-loop request generator (a verbatim copy of the
                  reference's: the same seed gives the same requests)
    batcher.py    per-peer continuous batcher: join/evict into fixed decode
                  slots, admission control, simulated-time SLO accounting,
                  the chaos hooks (die / revive / harvest / cancel)
    cache.py      slot-paged KV pool (block allocate / free / defrag) and
                  the speculative undo log
    model_exec.py batched decode and the k-token speculative verify over
                  the paged pool through the CUDA scatter / gather /
                  decode-attention kernels
    spec.py       peer-speculative decoding (SpecEngine)
    chaos.py      seeded fault injection and the router's defenses (a
                  verbatim copy of the reference's)
    router.py     round-robin / least-loaded / ensemble / speculative
                  routing, canaries, weight refresh from snapshots, the
                  chaos defenses and the fleet report
"""
from repro_torch.serve.fleet.batcher import (FleetConfig,  # noqa: F401
                                             FleetEngine, RequestRecord)
from repro_torch.serve.fleet.cache import PagedCachePool  # noqa: F401
from repro_torch.serve.fleet.chaos import (ChaosConfig,  # noqa: F401
                                           ChaosSchedule, ChaosStats,
                                           FleetDefense, PeerHealth)
from repro_torch.serve.fleet.router import (POLICIES,  # noqa: F401
                                            CanaryStats, FleetReport,
                                            FleetRouter)
from repro_torch.serve.fleet.spec import (SpecConfig,  # noqa: F401
                                          SpecEngine, SpecStats)
from repro_torch.serve.fleet.workload import (SCENARIOS,  # noqa: F401
                                              Request, Workload,
                                              generate_workload)
