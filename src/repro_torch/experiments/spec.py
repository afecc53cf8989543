"""Declarative sweep specs for the paper's experiment grid.

The paper's central claim (Sections 4-5) is a *grid* result: codistillation
matches synchronous data-parallel SGD across batch sizes and learning-rate
schedules once its regularization effect (alpha schedules, burn-in) is
accounted for. A :class:`SweepSpec` declares that grid once — the
cross-product of

    {batch size} x {LR schedule} x {exchange mode} x {alpha schedule}
                 x {peers} x {seeds}

— and :meth:`SweepSpec.cells` expands it into canonicalized, deduplicated
:class:`Cell`\\ s. Canonicalization encodes which axes are meaningful for
which mechanism: the ``allreduce`` baseline trains ONE model with no
distillation term, so its ``alpha`` and ``peers`` coordinates collapse
(otherwise the grid would re-run an identical baseline once per alpha x
peers combination). Seeds are a real axis: the aggregator reports final
loss +- range across them, the paper's error bars.

Specs load from YAML (committed under ``experiments/specs/``) or JSON;
every field of the file maps 1:1 onto a dataclass field below, so the file
format is the dataclass.
"""
from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

#: modes executed by the synchronous engine (``build_train_step`` + ``train``)
SYNC_MODES = ("allreduce", "codist", "codist-ckpt", "codist-pipelined")
#: modes executed by the async runtime (``AsyncScheduler``, clean schedule)
ASYNC_MODES = ("codist-async",)
KNOWN_MODES = SYNC_MODES + ASYNC_MODES


def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9.]+", "_", str(s)).strip("_")


@dataclass(frozen=True)
class LRPoint:
    """One point on the learning-rate-schedule axis (Section 4 / A.4).

    ``scale_with_batch`` applies Goyal et al.'s linear scaling rule
    (``lr * batch / base_batch``) so one point covers every batch size the
    way the paper's scaling study does.
    """
    name: str
    kind: str = "cosine"          # 'cosine' | 'step' | 'constant'
    lr: float = 1e-3
    warmup_frac: float = 0.1      # fraction of total steps spent warming up
    scale_with_batch: bool = False
    base_batch: int = 256

    def __post_init__(self):
        if self.kind not in ("cosine", "step", "constant"):
            raise ValueError(f"unknown LR schedule kind {self.kind!r}")

    def resolve_lr(self, batch: int) -> float:
        if self.scale_with_batch:
            return self.lr * batch / max(1, self.base_batch)
        return self.lr

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LRPoint":
        return cls(**d)


@dataclass(frozen=True)
class AlphaPoint:
    """One point on the distillation-weight-schedule axis.

    The three paper-motivated shapes: ``constant`` (vision, alpha=1),
    ``burn-in delayed`` (Anil et al.: alpha=0 for the first
    ``burn_in_frac`` of training), and ``ramped`` (NMT: alpha grown by
    ``growth`` per epoch). All three are expressible with the same triple.
    """
    name: str
    alpha0: float = 1.0
    growth: float = 1.0           # per-epoch multiplier (>1 => ramped)
    burn_in_frac: float = 0.0     # fraction of total steps with alpha == 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AlphaPoint":
        return cls(**d)


#: the collapsed alpha coordinate for mechanisms without a distillation term
NONE_ALPHA = AlphaPoint("none", alpha0=0.0)

#: ``model_overrides`` shrinking the standard reduced() config to a
#: seconds-per-cell smoke model — shared by the sweep_smoke benchmark and
#: the tests (``experiments/specs/paper_grid_small.yaml`` mirrors it)
TINY_OVERRIDES = (("d_model", 64), ("d_ff", 128), ("vocab_size", 128),
                  ("num_heads", 2), ("num_kv_heads", 2), ("head_dim", 32))


@dataclass(frozen=True)
class Cell:
    """One fully-resolved grid cell: everything ``run_cell`` needs."""
    sweep: str
    arch: str
    seq_len: int
    steps: int
    optimizer: str
    distill_loss: str
    batch: int
    lr: LRPoint
    mode: str
    alpha: AlphaPoint
    peers: int
    seed: int
    overrides: Tuple[Tuple[str, Any], ...] = ()

    @property
    def cell_id(self) -> str:
        """Stable filesystem-safe id; doubles as the dedup key (axis names
        are validated unique per spec, so ids are injective on the grid)."""
        return (f"{_slug(self.mode)}-b{self.batch}-{_slug(self.lr.name)}"
                f"-a{_slug(self.alpha.name)}-n{self.peers}-s{self.seed}")

    @property
    def grid_key(self) -> Tuple[str, int, str, str, int]:
        """Aggregation key: the grid coordinates MINUS the seed axis."""
        return (self.mode, self.batch, self.lr.name, self.alpha.name,
                self.peers)

    @property
    def baseline_key(self) -> Tuple[int, str]:
        """The (batch, lr) coordinates shared with the all-reduce baseline
        this cell is compared against in the paper-style gap tables."""
        return (self.batch, self.lr.name)


@dataclass(frozen=True)
class SweepSpec:
    """Declarative description of one experiment grid."""
    name: str
    arch: str = "qwen1.5-0.5b"
    seq_len: int = 16
    steps: int = 50
    optimizer: str = "adamw"
    distill_loss: str = "mse"
    seeds: Tuple[int, ...] = (0,)
    batch_sizes: Tuple[int, ...] = (8,)
    lr_schedules: Tuple[LRPoint, ...] = (LRPoint("cos"),)
    modes: Tuple[str, ...] = ("allreduce", "codist")
    alpha_schedules: Tuple[AlphaPoint, ...] = (AlphaPoint("const"),)
    peers: Tuple[int, ...] = (2,)
    # reduced-model config overrides (e.g. {"d_model": 64}) applied with
    # dataclasses.replace on get_reduced(arch) — lets CI grids shrink the
    # model below the standard reduced() size
    model_overrides: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        for axis in ("seeds", "batch_sizes", "lr_schedules", "modes",
                     "alpha_schedules", "peers"):
            if not getattr(self, axis):
                # an empty axis would silently expand to ZERO cells — a
                # typo'd grid must not read as a successful sweep
                raise ValueError(f"axis {axis!r} must be non-empty")
        unknown = [m for m in self.modes if m not in KNOWN_MODES]
        if unknown:
            raise ValueError(f"unknown mode(s) {unknown}; "
                             f"known: {list(KNOWN_MODES)}")
        for axis, pts in (("lr_schedules", self.lr_schedules),
                          ("alpha_schedules", self.alpha_schedules)):
            # cell ids carry SLUGGED axis names, so slugs (not just raw
            # names) must be unique or distinct cells would silently dedup
            slugs = [_slug(p.name) for p in pts]
            if len(slugs) != len(set(slugs)):
                raise ValueError(
                    f"duplicate {axis} names after slugging: "
                    f"{[p.name for p in pts]} -> {slugs}")
        if not re.match(r"^[A-Za-z0-9_\-]+$", self.name or ""):
            raise ValueError(f"sweep name {self.name!r} must be a slug "
                             "(it names the results directory)")
        if min(self.batch_sizes) < 1 or min(self.peers) < 2:
            raise ValueError("batch_sizes must be >=1 and peers >=2")

    # ------------------------------------------------------------------
    def cells(self) -> List[Cell]:
        """Expand the cross-product, canonicalize collapsed axes, dedup,
        and order baseline-first so truncated runs (``--max-cells``) still
        contain the all-reduce reference for each (batch, lr) group."""
        out: List[Cell] = []
        seen = set()
        for batch in self.batch_sizes:
            for lrp in self.lr_schedules:
                for mode in self.modes:
                    for alphap in self.alpha_schedules:
                        for n in self.peers:
                            for seed in self.seeds:
                                a, p = alphap, n
                                if mode == "allreduce":
                                    a, p = NONE_ALPHA, 1
                                cell = Cell(
                                    sweep=self.name, arch=self.arch,
                                    seq_len=self.seq_len, steps=self.steps,
                                    optimizer=self.optimizer,
                                    distill_loss=self.distill_loss,
                                    batch=batch, lr=lrp, mode=mode,
                                    alpha=a, peers=p, seed=seed,
                                    overrides=self.model_overrides)
                                if cell.cell_id in seen:
                                    continue
                                seen.add(cell.cell_id)
                                out.append(cell)
        out.sort(key=lambda c: (c.batch, c.lr.name, c.mode != "allreduce",
                                c.mode, c.alpha.name, c.peers, c.seed))
        return out


# ----------------------------------------------------------------------------
# (de)serialization
# ----------------------------------------------------------------------------

def spec_from_dict(doc: Dict[str, Any]) -> SweepSpec:
    """Dict (parsed YAML/JSON) -> SweepSpec. Lists become tuples; the two
    structured axes accept plain dicts."""
    d = dict(doc)
    if "lr_schedules" in d:
        d["lr_schedules"] = tuple(
            p if isinstance(p, LRPoint) else LRPoint.from_dict(p)
            for p in d["lr_schedules"])
    if "alpha_schedules" in d:
        d["alpha_schedules"] = tuple(
            p if isinstance(p, AlphaPoint) else AlphaPoint.from_dict(p)
            for p in d["alpha_schedules"])
    if "model_overrides" in d and isinstance(d["model_overrides"], dict):
        d["model_overrides"] = tuple(sorted(d["model_overrides"].items()))
    for key in ("seeds", "batch_sizes", "modes", "peers"):
        if key in d:
            d[key] = tuple(d[key])
    known = {f.name for f in dataclasses.fields(SweepSpec)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown spec field(s) {sorted(unknown)}; "
                         f"known: {sorted(known)}")
    return SweepSpec(**d)


def spec_to_dict(spec: SweepSpec) -> Dict[str, Any]:
    return dataclasses.asdict(spec)


def cell_to_dict(cell: Cell) -> Dict[str, Any]:
    return dataclasses.asdict(cell)


def load_spec(path: str) -> SweepSpec:
    """Load a spec from ``.yaml``/``.yml`` (needs pyyaml) or ``.json``."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as e:  # pragma: no cover - container ships pyyaml
            raise RuntimeError(
                f"loading {path} needs pyyaml (pip install pyyaml) — or "
                "convert the spec to .json, which loads without it") from e
        doc = yaml.safe_load(text)
    else:
        doc = json.loads(text)
    if not isinstance(doc, dict):
        raise ValueError(f"spec {path} must be a mapping, got {type(doc)}")
    return spec_from_dict(doc)
