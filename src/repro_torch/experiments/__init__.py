"""Paper-grid experiment harness.

A :class:`SweepSpec` declares the paper's grid — {batch} x {LR schedule}
x {exchange mode} x {alpha schedule} x {peers} x {seeds} — ``run_sweep``
executes it through the step engine / async runtime on the card with
crash-safe per-cell persistence, and ``aggregate`` reduces the results into
the paper-style tables. The reference's ``repro.experiments``, whose files
and tables it writes.
"""
from repro_torch.experiments.aggregate import (  # noqa: F401
    QUALITY_FACTORS,
    aggregate,
    aggregate_and_write,
    comm_to_quality,
    load_summaries,
    render_markdown,
    write_outputs,
)
from repro_torch.experiments.runner import (  # noqa: F401
    CellResult,
    cell_paths,
    load_summary,
    run_cell,
    run_sweep,
    summary_is_valid,
    sweep_dir_for,
)
from repro_torch.experiments.spec import (  # noqa: F401
    ASYNC_MODES,
    AlphaPoint,
    Cell,
    KNOWN_MODES,
    LRPoint,
    NONE_ALPHA,
    SYNC_MODES,
    TINY_OVERRIDES,
    SweepSpec,
    cell_to_dict,
    load_spec,
    spec_from_dict,
    spec_to_dict,
)
