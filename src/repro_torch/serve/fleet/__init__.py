"""Continuous-batching serving fleet (clean path) over the paged KV pool.

    workload.py   seeded open-loop request generator (a verbatim copy of the
                  reference's: the same seed gives the same requests)
    batcher.py    per-peer continuous batcher: join/evict into fixed decode
                  slots, admission control, simulated-time SLO accounting
    cache.py      slot-paged KV pool (block allocate / free / defrag)
    model_exec.py batched decode over the paged pool through the CUDA
                  scatter / gather / decode-attention kernels
    router.py     round-robin / least-loaded routing and the fleet report
"""
from repro_torch.serve.fleet.batcher import (FleetConfig,  # noqa: F401
                                             FleetEngine, RequestRecord)
from repro_torch.serve.fleet.cache import PagedCachePool  # noqa: F401
from repro_torch.serve.fleet.router import (POLICIES,  # noqa: F401
                                            FleetReport, FleetRouter)
from repro_torch.serve.fleet.workload import (SCENARIOS,  # noqa: F401
                                              Request, Workload,
                                              generate_workload)
