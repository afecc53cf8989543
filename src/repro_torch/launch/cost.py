"""Cost model of one torch step on H100s: per-device FLOPs, bytes and
collectives, counted from the config.

The reference compiles each (arch x shape x mesh) with XLA and reads
``cost_analysis()`` and the HLO text (``launch/hlo_analysis.py``,
``dryrun.corrected_cost`` / ``_extract_cost``). Nothing in PyTorch emits
HLO text, so the HLO regexes and ``parse_collectives`` have no counterpart
here; neither has ``models/runtime_flags.py``, whose probes exist because
XLA counts a scanned layer body once: this model counts every layer. It
counts, sub-layer by sub-layer, the work the port's own step does:

* GEMMs (``torch.matmul`` / einsum / convolution), kept apart so that they
  can be held against ``torch.utils.flop_counter.FlopCounterMode``, which
  sees the plain versions' products on the CPU and no ctypes launch on the
  card: attention (GQA; the port forms the full S x T scores, masked, and
  a decode step reads the whole cache, ``min(cap, window)`` long in a
  ring), the dense FFN, MoE at top_k rows a token (no drops: an upper bound
  where a capacity drops some) plus the router, Mamba, RWKV6 (its
  64-token chunked WKV, the sequential scan off the chunk), the enc-dec
  encoder and cross attention, the VLM patch prefix, the conv nets and the
  head. A train step is forward + backward (two products a forward product,
  one where the port's autograd forms one: the conv stem, the MLP's first
  layer, the first chunk's carried-state product; none for the last
  chunk's state, which the loss never reads) + the remat forward of the
  layers.
* the hand-written kernels' work: the loss rows and the paged decode rows,
  their bytes by ``PERF.md`` §6's rule (each input and output byte once);
  ``chip_smoke.py`` computes its kernels' bound columns with these same
  helpers;
* elementwise work the port materializes at scale: the RWKV chunk's
  pairwise decay and the optimizer's passes.

Bytes of a GEMM are its operands and result once; the embedding table is
read by row (the tokens' rows), not whole. The sum is a lower bound on the
bytes a step moves: it leaves out the elementwise passes between products.

**Across devices** the work is split by the placements of
``launch/sharding.py`` (params, optimizer state, batch) and
``models/sharding_hints.py`` (activations): a product shares its work over
the batch's axes and the mesh axes that shard its weight beyond the FSDP
axis (which is gathered before use); attention's core over tp where the
scores hint shards heads or queries. A replicated fallback counts on every
device, the waste XLA's count would show. The collectives are built from
the same placements, their groups from the mesh's device ids:

* FSDP: an all-gather of each fsdp-sharded weight in the forward and again
  in the backward, and a reduce-scatter of its gradient (each per
  microbatch); a gradient replicated over a batch axis is all-reduced;
* TP: an all-reduce of the output after each row-parallel product, and one
  of the input gradient in the backward;
* the all-reduce baseline's gradient sync over (pod, data);
* the codist wire: an all-gather over "pod" of the peers' predictions, at
  ``comm_model.prediction_bits_lm`` for the wire's compression at the
  logits' own bits (the activation dtype's; top-k indices at 32), of the V /
  tp columns a device holds of a logits-shaped wire (the top-k wire is
  whole on each device); a classifier's at
  ``comm_model.prediction_bits_classifier``, one row an example;
* expert parallelism: an all-to-all of each device's (G, E, C, d)
  capacity buffers each way, the layout the reference's partitioner
  exchanges (C the GShard capacity of a train step; no drops in serving).

An op's ``operand_bytes`` is per device (the wire's: what a device
receives, as ``comm_model`` bills it, over the columns the device holds).
``StepCost.bound_s`` is the larger of the FLOPs over the peak and the bytes
over the HBM rate; ``launch/roofline.py`` adds the collective term.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (InputShape, ModelConfig, RWKVConfig,
                                      SSMConfig)
from repro_torch.core import comm_model as cm
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import Mesh
from repro_torch.models.sharding_hints import hint_spec
from repro_torch.models.transformer import _sub_kinds

_RWKV_CHUNK = 64          # models/rwkv.py CHUNK
_OPT_FLOPS = {"sgdm": 4, "adamw": 12}   # elementwise FLOPs a parameter


def nbytes(dtype: str) -> int:
    """Bytes an element of the dtype named ``dtype`` ("bfloat16", ...)."""
    return getattr(torch, str(dtype).replace("torch.", "")).itemsize


# ----------------------------------------------------------------------------
# collectives (the reference's hlo_analysis records, filled from placements)
# ----------------------------------------------------------------------------

@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    operand_bytes: int
    groups: Optional[List[List[int]]]
    cross_pod: bool
    line: str = ""
    cross_node: bool = False


@dataclass
class CollectiveSummary:
    ops: List[CollectiveOp] = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(o.operand_bytes for o in self.ops)

    @property
    def cross_pod_bytes(self) -> int:
        return sum(o.operand_bytes for o in self.ops if o.cross_pod)

    @property
    def intra_pod_bytes(self) -> int:
        return self.total_bytes - self.cross_pod_bytes

    @property
    def inter_node_bytes(self) -> int:
        return sum(o.operand_bytes for o in self.ops if o.cross_node)

    @property
    def intra_node_bytes(self) -> int:
        return self.total_bytes - self.inter_node_bytes

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for o in self.ops:
            out[o.kind] = out.get(o.kind, 0) + o.operand_bytes
        return out

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for o in self.ops:
            out[o.kind] = out.get(o.kind, 0) + 1
        return out


def _crosses_pods(groups: Optional[List[List[int]]],
                  devices_per_pod: int) -> bool:
    if not groups or devices_per_pod <= 0:
        return False
    for g in groups:
        if len({d // devices_per_pod for d in g}) > 1:
            return True
    return False


def _crosses_nodes(groups: Optional[List[List[int]]]) -> bool:
    return any(len({rl.node_of(d) for d in g}) > 1 for g in groups or [])


# ----------------------------------------------------------------------------
# the hand-written kernels' work (PERF.md §6: each input and output once)
# ----------------------------------------------------------------------------

# by (row, distillation mode): the logits-sized (T, V) tensors a loss row
# reads and writes, its (T,) fp32 vectors (labels as int32 included) and
# its fp32 operations a logits element: CE forward (max, sub, exp, add,
# add), CE backward (sub, exp, mul, sub, sub, add), and what each
# distillation mode adds (mse: sub, mul, add forward, sub, mul, mul back;
# kl: the target's max, sub, exp, add, sub, mul, add forward and exp, sub,
# mul, sub back)
LOSS_KERNELS = {
    ("fused_cross_entropy", None): (1, 2, 5),         # row 5: logits -> nll
    ("fused_cross_entropy_parts", None): (1, 4, 5),   # row 6: nll, smooth, logZ
    ("fused_cross_entropy_grad", None): (2, 4, 6),    # row 7: -> dlogits
    ("fused_distill_loss", "mse"): (2, 1, 3),         # row 8: logits, targets
    ("fused_distill_loss", "kl"): (2, 1, 11),
    ("fused_distill_kl_parts", "kl"): (2, 4, 11),     # row 9
    ("fused_distill_mse_grad", "mse"): (3, 1, 3),     # row 10 (+1 with dB)
    ("fused_distill_kl_grad", "kl"): (3, 4, 10),      # row 11 (+1 with dB)
    ("fused_ce_distill_parts", "mse"): (2, 5, 8),     # row 12
    ("fused_ce_distill_parts", "kl"): (2, 7, 11),
    ("fused_ce_distill_grad", "mse"): (3, 5, 10),     # row 13 (+1 with dt)
    ("fused_ce_distill_grad", "kl"): (3, 7, 12),
}


def kernel_bound_ms(n_bytes: float, n_ops: float,
                    peak: float = rl.PEAK_FLOPS_FP32) -> Tuple[float, str]:
    """The least time (ms) a launch can take on the card and what sets it:
    its bytes over the HBM rate or its operations over ``peak``."""
    tb = n_bytes / rl.HBM_BW * 1e3
    tf = n_ops / peak * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def loss_kernel_io(kernel: str, t: int, v: int, itemsize: int,
                   target_grad: bool = False, mode: str = "mse"
                   ) -> Tuple[float, float]:
    """(bytes, FLOPs) of one launch of a loss row over T tokens of V
    logits of ``itemsize`` bytes; ``mode`` is the distillation loss of rows
    8, 12 and 13 (the others have one), ``target_grad`` adds the targets'
    gradient (rows 10, 11, 13)."""
    if kernel.startswith("fused_cross_entropy"):
        mode = None
    elif "_kl_" in kernel:
        mode = "kl"
    elif "_mse_" in kernel:
        mode = "mse"
    big, small, ops = LOSS_KERNELS[(kernel, mode)]
    if target_grad:
        big += 1
    return (float(big * t * v * itemsize + small * t * 4),
            float(ops * t * v))


def paged_decode_io(lengths: Sequence[int], heads: int, kv_heads: int,
                    hd: int, pool_itemsize: int, q_itemsize: int,
                    max_blocks: int, quant: bool = False,
                    byte_rows: Optional[int] = None
                    ) -> Tuple[float, float]:
    """Rows 1 / 1q, one launch: each live K/V row (the slot's length + the
    token written this tick) and its scale, q and the output, the table and
    the lengths; 4 H hd operations a live position. ``byte_rows`` counts
    the K/V rows read where slots share them (the verify's pseudo-slots)."""
    rows = sum(int(x) + 1 for x in lengths)
    row_b = kv_heads * hd * pool_itemsize + (4 if quant else 0)
    s = len(lengths)
    q_b = s * heads * hd * q_itemsize
    return (float(2 * (byte_rows or rows) * row_b + 2 * q_b
                  + s * max_blocks * 4 + s * 4),
            float(4 * heads * hd * rows))


def paged_scatter_io(writers: int, row_bytes: int, num_blocks: int,
                     quant_row_bytes: int = 0) -> float:
    """Rows 2 / 4, one K+V launch: each writer's K and V row read and
    written (a quantized row: read at ``row_bytes``, written at
    ``quant_row_bytes`` with its scale) and the write map's two int32
    entries a pool block."""
    if quant_row_bytes:
        return float(2 * writers * (row_bytes + quant_row_bytes)
                     + 2 * num_blocks * 4)
    return float(4 * writers * row_bytes + 2 * num_blocks * 4)


def paged_gather_io(live_blocks: int, slots: int, max_blocks: int,
                    block_bytes: int) -> float:
    """Row 3, one launch: the live blocks read, the dense (slots x
    max_blocks) copy written, the table and the counts."""
    return float(live_blocks * block_bytes + slots * max_blocks * block_bytes
                 + slots * max_blocks * 4 + slots * 4)


# ----------------------------------------------------------------------------
# the step's cost
# ----------------------------------------------------------------------------

@dataclass
class StepCost:
    """Per-device counts of one step."""
    gemm_flops: float = 0.0
    kernel_flops: float = 0.0
    other_flops: float = 0.0
    gemm_bytes: float = 0.0
    kernel_bytes: float = 0.0
    other_bytes: float = 0.0
    argument_bytes: float = 0.0
    temp_bytes: float = 0.0
    fp32: bool = False
    collectives: CollectiveSummary = field(default_factory=CollectiveSummary)
    # name -> [flops, bytes, launches or products] (per device)
    parts: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def flops(self) -> float:
        return self.gemm_flops + self.kernel_flops + self.other_flops

    @property
    def bytes(self) -> float:
        return self.gemm_bytes + self.kernel_bytes + self.other_bytes

    @property
    def peak_flops(self) -> float:
        return rl.PEAK_FLOPS_FP32 if self.fp32 else rl.PEAK_FLOPS

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes / rl.HBM_BW

    @property
    def bound_s(self) -> float:
        """The least time the card could take for the step's counted work:
        the larger of FLOPs over the peak and bytes over the HBM rate."""
        return max(self.compute_s, self.memory_s)

    @property
    def bound_by(self) -> str:
        return "operations" if self.compute_s >= self.memory_s else "bytes"

    def add(self, kind: str, name: str, flops: float, nbytes: float,
            n: float = 1.0) -> None:
        setattr(self, f"{kind}_flops", getattr(self, f"{kind}_flops") + flops)
        setattr(self, f"{kind}_bytes", getattr(self, f"{kind}_bytes") + nbytes)
        p = self.parts.setdefault(name, [0.0, 0.0, 0.0])
        p[0] += flops
        p[1] += nbytes
        p[2] += n


@dataclass
class _Gemm:
    """One forward product of the global batch: FLOPs, its operand bytes
    (activation side ``a``, weight side ``w``, result ``c``), the weight's
    path (None: activation x activation), how many products its backward
    forms, how many times the step runs it, and how its work splits
    ("w": by the weight's placement, "scores": the attention core,
    "inner:<leaf>": a recurrent core, as its producer weight)."""
    part: str
    flops: float
    a: float
    w: float
    c: float
    leaf: Optional[str] = None
    grads: int = 2
    count: int = 1
    split: str = "w"
    layer: bool = True


class _Walker:
    """Forward products of one model over a global batch."""

    def __init__(self, cfg, act: int, wbytes: int):
        self.cfg, self.act, self.wb = cfg, act, wbytes
        self.out: List[_Gemm] = []
        self.layer = True            # remat recomputes it

    def mm(self, part, m, k, n, leaf=None, count=1, grads=2, split="w",
           batch=1, fp32=False, a_elems=None, w_elems=None, w_item=None):
        """``batch`` products (m x k) @ (k x n); the activation side reads
        ``a_elems`` (default batch m k), the weight side ``w_elems``
        (default batch k n) elements."""
        e = 4 if fp32 else self.act
        a = (batch * m * k if a_elems is None else a_elems) * e
        wi = e if leaf is None else (w_item or self.wb)
        w = (batch * k * n if w_elems is None else w_elems) * wi
        self.out.append(_Gemm(part, 2.0 * batch * m * k * n, float(a),
                              float(w), float(batch * m * n * e), leaf,
                              grads, count, split, self.layer))

    # -- sub-layers ---------------------------------------------------------
    def attention(self, pre, b, s, t, n, kv_tokens=None, proj_kv=True):
        """q from b s rows, k / v from ``kv_tokens`` rows (default b s),
        the scores and the combine over t keys (GQA: K and V read at their
        own head count), wo; ``n`` layers."""
        c = self.cfg
        d, h, kvh, hd = (c.d_model, c.num_heads, c.num_kv_heads,
                         c.resolved_head_dim)
        kv_rows = b * s if kv_tokens is None else kv_tokens
        self.mm(f"{pre}.q", b * s, d, h * hd, f"{pre}/wq", n)
        if proj_kv:
            self.mm(f"{pre}.k", kv_rows, d, kvh * hd, f"{pre}/wk", n)
            self.mm(f"{pre}.v", kv_rows, d, kvh * hd, f"{pre}/wv", n)
        self.mm(f"{pre}.scores", s, hd, t, None, n, split="scores",
                batch=b * h, w_elems=b * kvh * hd * t)
        self.mm(f"{pre}.combine", s, t, hd, None, n, split="scores",
                batch=b * h, w_elems=b * kvh * t * hd)
        self.mm(f"{pre}.o", b * s, h * hd, d, f"{pre}/wo", n)

    def ffn(self, pre, rows, n, tail=False):
        """``tail``: the product ends a remat layer and feeds only the
        residual add, so the remat forward (which stops once every tensor
        the backward needs is back) does not run it again."""
        c = self.cfg
        d, f = c.d_model, c.d_ff
        if c.act in ("silu", "geglu"):
            self.mm(f"{pre}.gate", rows, d, f, f"{pre}/w_gate", n)
        self.mm(f"{pre}.up", rows, d, f, f"{pre}/w_up", n)
        layer, self.layer = self.layer, self.layer and not tail
        self.mm(f"{pre}.down", rows, f, d, f"{pre}/w_down", n)
        self.layer = layer

    def moe(self, pre, rows, n, tail=False):
        """The fp32 router, then every token's top_k rows through the
        experts (no drops); an expert's weights are read where a row
        reaches it."""
        c = self.cfg
        m = c.moe
        d, f, e = c.d_model, c.d_ff, m.num_experts
        self.mm(f"{pre}.router", rows, d, e, f"{pre}/router", n, fp32=True,
                w_item=4)
        routed = rows * m.top_k
        touched = min(e, routed)
        for name, (k_, n_) in (("w_gate", (d, f)), ("w_up", (d, f)),
                               ("w_down", (f, d))):
            if name == "w_gate" and c.act not in ("silu", "geglu"):
                continue
            self.mm(f"{pre}.experts", routed, k_, n_, f"{pre}/{name}", n,
                    w_elems=touched * k_ * n_)
        if m.dense_residual:
            self.ffn(f"{pre}/residual", rows, n, tail)

    def mamba(self, pre, b, s, n, decode=False):
        c = self.cfg
        ss = c.ssm or SSMConfig()
        d = c.d_model
        di = ss.expand * d
        r = ss.dt_rank or -(-d // 16)
        rows = b * s
        inner = f"inner:{pre}/in_proj"
        self.mm(f"{pre}.in_proj", rows, d, 2 * di, f"{pre}/in_proj", n)
        if decode:     # the conv window: einsum over d_conv a channel
            self.mm(f"{pre}.conv", b, ss.d_conv, 1, None, n, split=inner,
                    batch=di)
        self.mm(f"{pre}.x_proj", rows, di, r + 2 * ss.d_state,
                f"{pre}/x_proj", n)
        self.mm(f"{pre}.dt_proj", rows, r, di, f"{pre}/dt_proj", n)
        # y = <h_t, C_t> a channel, in fp32
        self.mm(f"{pre}.scan_y", 1, ss.d_state, 1, None, n, split=inner,
                batch=rows * di, fp32=True)
        self.mm(f"{pre}.out_proj", rows, di, d, f"{pre}/out_proj", n)

    def rwkv(self, pre_tm, pre_cm, b, s, n):
        c = self.cfg
        rk = c.rwkv or RWKVConfig()
        d, f = c.d_model, c.d_ff
        hd = rk.head_dim
        h = d // hd
        rows = b * s
        self.mm(f"{pre_tm}.mix_lora_a", rows, d, 5 * rk.mix_lora,
                f"{pre_tm}/mix_lora_a", n)
        self.mm(f"{pre_tm}.mix_lora_b", rows, rk.mix_lora, d,
                f"{pre_tm}/mix_lora_b", n, batch=5, a_elems=5 * rows
                * rk.mix_lora)
        for w in ("w_r", "w_k", "w_v", "w_g"):
            self.mm(f"{pre_tm}.{w}", rows, d, d, f"{pre_tm}/{w}", n)
        self.mm(f"{pre_tm}.decay_lora_a", rows, d, rk.decay_lora,
                f"{pre_tm}/decay_lora_a", n)
        self.mm(f"{pre_tm}.decay_lora_b", rows, rk.decay_lora, d,
                f"{pre_tm}/decay_lora_b", n)
        inner = f"inner:{pre_tm}/w_r"
        bh = b * h
        if s % _RWKV_CHUNK == 0:
            nc, ck = s // _RWKV_CHUNK, _RWKV_CHUNK
            # the carried state's read: chunk 0's state is a constant zero
            # (its backward forms one product), the others' two
            self.mm(f"{pre_tm}.wkv_inter", ck, hd, hd, None, n, grads=1,
                    split=inner, batch=bh, fp32=True)
            self.mm(f"{pre_tm}.wkv_inter", ck, hd, hd, None, n * (nc - 1),
                    split=inner, batch=bh, fp32=True)
            self.mm(f"{pre_tm}.wkv_intra", ck, ck, hd, None, n * nc,
                    split=inner, batch=bh, fp32=True)
            # the state update; the loss never reads the last chunk's
            self.mm(f"{pre_tm}.wkv_state", hd, ck, hd, None, n * (nc - 1),
                    split=inner, batch=bh, fp32=True)
            self.mm(f"{pre_tm}.wkv_state", hd, ck, hd, None, n, grads=0,
                    split=inner, batch=bh, fp32=True)
        else:          # the sequential scan: one product a position
            self.mm(f"{pre_tm}.wkv_seq", 1, hd, hd, None, n, split=inner,
                    batch=bh * s, fp32=True)
        self.mm(f"{pre_tm}.w_o", rows, d, d, f"{pre_tm}/w_o", n)
        self.mm(f"{pre_cm}.w_k", rows, d, f, f"{pre_cm}/w_k", n)
        self.mm(f"{pre_cm}.w_v", rows, f, d, f"{pre_cm}/w_v", n)
        self.mm(f"{pre_cm}.w_r", rows, d, d, f"{pre_cm}/w_r", n)

    def head(self, rows):
        c = self.cfg
        leaf = "embed/tokens" if c.tie_embeddings else "embed/head"
        self.layer = False
        self.mm("head", rows, c.d_model, c.padded_vocab, leaf, 1)
        self.layer = True


def _lm_gemms(cfg: ModelConfig, kind: str, b: int, s: int, cap: int,
              act: int, wb: int, paged: bool) -> _Walker:
    """Forward products of ``LM`` / ``EncDecLM`` over b sequences of s
    positions (``kind`` train / prefill / decode: a decode step's s is 1
    and its attention reads ``cap`` cached keys, or leaves its core to the
    paged kernel)."""
    w = _Walker(cfg, act, wb)
    decode = kind == "decode"
    if cfg.is_encdec:
        m = cfg.num_audio_frames or (cap if decode else s)
        if not decode:           # the encoder (no remat in the port)
            w.layer = False
            w.attention("enc_layers/attn", b, m, m, cfg.encoder_layers)
            w.ffn("enc_layers/ffn", b * m, cfg.encoder_layers)
            w.layer = True
        nd = cfg.num_layers
        w.attention("dec_layers/self_attn", b, s, cap if decode else s, nd)
        w.attention("dec_layers/cross_attn", b, s, m, nd, kv_tokens=b * m,
                    proj_kv=not decode)
        w.ffn("dec_layers/ffn", b * s, nd, tail=True)
        w.head(b * (s if kind == "train" else 1))
        return w
    kinds = _sub_kinds(cfg)
    n = cfg.num_layers // len(kinds)
    t = ((min(cap, cfg.sliding_window) if cfg.sliding_window > 0 else cap)
         if decode else s)
    c = cfg
    d, h, kvh, hd = c.d_model, c.num_heads, c.num_kv_heads, c.resolved_head_dim
    for i, (mixer, ffn) in enumerate(kinds):
        pre = f"layers/sub{i}"
        if mixer == "attn" and paged:    # the kernel does the core
            w.mm(f"{pre}/mix.q", b, d, h * hd, f"{pre}/mix/wq", n)
            w.mm(f"{pre}/mix.k", b, d, kvh * hd, f"{pre}/mix/wk", n)
            w.mm(f"{pre}/mix.v", b, d, kvh * hd, f"{pre}/mix/wv", n)
            w.mm(f"{pre}/mix.o", b, h * hd, d, f"{pre}/mix/wo", n)
        elif mixer == "attn":
            w.attention(f"{pre}/mix", b, s, t, n)
        elif mixer == "ssm":
            w.mamba(f"{pre}/mix", b, s, n, decode=decode)
        else:
            w.rwkv(f"{pre}/mix", f"{pre}/ffn", b, s, n)
        last = i == len(kinds) - 1
        if ffn == "moe":
            w.moe(f"{pre}/ffn", b * s, n, tail=last)
        elif ffn == "dense":
            w.ffn(f"{pre}/ffn", b * s, n, tail=last)
    text = s - (cfg.num_patches if not decode else 0)
    w.head(b * (text if kind == "train" else 1))
    return w


def _conv_gemms(cfg, b: int) -> _Walker:
    """The conv nets' convolutions (XLA's SAME padding; stride 2 at the
    first block of every stage but stage 0) and the fp32 head; the stem's
    input is data (one backward product)."""
    w = _Walker(cfg, 4, 4)
    hw = cfg.image_size
    stem = cfg.widths[0] if not cfg.bottleneck else max(16, cfg.widths[0] // 4)

    def conv(name, hw_in, hw_out, cin, cout, k, grads=2):
        w.mm(name, b * hw_out * hw_out, cin * k * k, cout, name, 1,
             grads=grads, a_elems=b * hw_in * hw_in * cin)

    conv("stem", hw, hw, 3, stem, 3, grads=1)
    cin = stem
    for st, (depth, width) in enumerate(zip(cfg.depths, cfg.widths)):
        for blk in range(depth):
            stride = 2 if (st > 0 and blk == 0) else 1
            out = -(-hw // stride)
            pre = f"s{st}b{blk}"
            if cfg.bottleneck:
                mid = width // 4
                conv(f"{pre}/conv1", hw, hw, cin, mid, 1)
                conv(f"{pre}/conv2", hw, out, mid, mid, 3)
                conv(f"{pre}/conv3", out, out, mid, width, 1)
            else:
                conv(f"{pre}/conv1", hw, out, cin, width, 3)
                conv(f"{pre}/conv2", out, out, width, width, 3)
            if cin != width:
                conv(f"{pre}/proj", hw, out, cin, width, 1)
            hw, cin = out, width
    w.layer = False
    w.mm("head", b, cin, cfg.num_classes, "head", 1)
    return w


def _mlp_gemms(cfg, b: int) -> _Walker:
    """The MLP's layers in fp32; the first one's input is data."""
    w = _Walker(cfg, 4, 4)
    dims = (cfg.in_dim, *cfg.hidden, cfg.num_classes)
    for i, (k, n) in enumerate(zip(dims, dims[1:])):
        w.mm(f"w{i}", b, k, n, f"w{i}", 1, grads=1 if i == 0 else 2)
    return w


def _model(cfg):
    if getattr(cfg, "kind", None) == "mlp":
        from repro_torch.models.mlp import MLP
        return MLP(cfg)
    from repro_torch.models import build_model
    return build_model(cfg)


def _leaf_shapes(cfg) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """path -> (shape, itemsize) of the parameter tree (the meta init)."""
    from repro_torch.launch.specs import params_specs
    return {p: (tuple(x.shape), x.element_size())
            for p, x in sh.tree_flatten_with_path(params_specs(_model(cfg)))}


def _ways(spec, sizes, skip=()) -> int:
    n = 1
    for a in sh.spec_axes(spec):
        if a not in skip:
            n *= sizes[a]
    return n


def step_cost(cfg, shape: InputShape, mode: str, codist_n: int = 2,
              remat: bool = True, microbatch: Optional[int] = None,
              mesh: Optional[Mesh] = None, variant: Optional[Dict] = None,
              codist_extra: Optional[Dict] = None) -> StepCost:
    """Per-device cost of one step of ``cfg`` (a ``ModelConfig``, or a
    conv net's / the MLP's config for a train step) at ``shape``.

    ``mode``: "codist" (``codist_n`` stacked peers, the prediction
    exchange), "allreduce" (one model and its gradient sync), "prefill" or
    "decode" (the shape's kind decides between a train step and these).
    ``mesh`` None is one device. ``microbatch`` k repeats the FSDP
    collectives k times. ``variant`` takes the reference's
    ``decode_sharding`` / ``moe_expert_axis`` / ``train_fsdp_axis``, the
    step's ``optimizer`` ("sgdm", the dry run's, or "adamw") and
    ``opt_dtype`` (default the param dtype), and for a fleet decode tick
    ``paged``: {"lengths": [...], "num_blocks", "max_blocks",
    "cache_dtype"}. ``codist_extra``: the wire's ``compression`` /
    ``topk`` / ``subsample`` and the ``distill_loss``."""
    variant = dict(variant or {})
    extra = dict(codist_extra or {})
    mesh = mesh or Mesh((1, 1), ("data", "model"))
    sizes = mesh.shape
    small = hasattr(cfg, "kind")   # conv nets, MLP: pure DP, no remat
    remat = remat and not small
    act = 4 if small else nbytes(cfg.dtype)
    pdt = "float32" if small else cfg.param_dtype
    wb = nbytes(pdt)
    train = shape.kind == "train"
    stacked = train and mode == "codist"
    n_models = codist_n if stacked else 1
    b, s = shape.global_batch, shape.seq_len
    k = microbatch or 1
    paged = variant.get("paged")
    out = StepCost(fp32=act == 4)

    # ---- placements ----
    ds = variant.get("decode_sharding", "fsdp")
    fsdp = (variant.get("train_fsdp_axis", "data") if train
            else (None if ds == "ws" else "data"))
    tp = "model" if "model" in sizes else None
    tp_size = sizes.get("model", 1)
    leaves = _leaf_shapes(cfg)
    lead = 1 if stacked else 0

    def full(shp):
        return (n_models, *shp) if stacked else shp

    specs = {p: (sh.P(*([None] * len(full(shp)))) if small else sh.param_spec(
        p, full(shp), mesh, stacked, sh._scanned(p), fsdp, tp,
        variant.get("moe_expert_axis"), two_d_ffn=ds == "2d" and not train))
        for p, (shp, _) in leaves.items()}
    # a microbatch's rows are placed as a batch's (the reference's
    # ``batch_shardings(..., microbatched=True)`` of (k, B/k, ...))
    bshape = ((n_models, b // n_models // k, s) if stacked
              else (b // k, s))
    bspec = sh.batch_shardings({"x": torch.empty(bshape, device="meta")},
                               mesh, stacked=stacked)["x"]
    if ds == "repl-batch" and shape.kind == "decode":
        bspec = sh.P(None, None)
    batch_axes = sh.spec_axes(bspec)
    batch_ways = _ways(bspec, sizes)
    # peers whose rows a device holds: all of them unless "pod" splits them
    peers_here = n_models // (sizes["pod"] if stacked and "pod" in batch_axes
                              else 1)
    replicated_over = set(batch_axes) | {fsdp}

    def w_ways(leaf) -> int:
        return _ways(specs[leaf][lead:], sizes, skip=replicated_over)

    q_len = 1 if shape.kind == "decode" else s
    scores_ways = 1 if small else _tp_ways(
        "scores", (b, cfg.num_heads, q_len, s), tp, tp_size)

    # ---- products ----
    if small:
        walk = (_mlp_gemms(cfg, b) if cfg.kind == "mlp"
                else _conv_gemms(cfg, b))
    else:
        walk = _lm_gemms(cfg, shape.kind, b,
                         1 if shape.kind == "decode" else s, s, act, wb,
                         paged is not None)
    for g in walk.out:
        if g.split == "w":
            wdiv = w_ways(g.leaf)
        elif g.split == "scores":
            wdiv = batch_ways * scores_ways
        else:
            wdiv = batch_ways * w_ways(g.split[len("inner:"):])
        ways = batch_ways * w_ways(g.leaf) if g.split == "w" else wdiv
        passes = 1 + ((g.grads + (1 if remat and g.layer else 0))
                      if train else 0)
        out.add("gemm", g.part, g.flops / ways * passes * g.count,
                ((g.a + g.c) / ways + g.w / wdiv) * passes * g.count,
                passes * g.count)

    if not small:
        # the embedding rows of the step's tokens (and their gradient)
        rows = b * (1 if shape.kind == "decode" else s) / batch_ways
        out.add("other", "embed.rows", 0.0,
                rows * cfg.d_model * wb * (2 if train else 1))
        if cfg.family == "ssm" and shape.kind != "decode" \
                and s % _RWKV_CHUNK == 0:
            # the chunk's (B, C, C, H, hd) fp32 pairwise decay, formed and
            # read once a pass (forward, backward, remat)
            el = b * s * _RWKV_CHUNK * cfg.d_model * cfg.num_layers
            passes = (2 + (1 if remat else 0)) if train else 1
            ways = batch_ways * w_ways("layers/sub0/mix/w_r")
            out.add("other", "rwkv.pairwise_decay",
                    6.0 * el / ways * passes, 8.0 * el / ways * passes,
                    passes)

    # ---- the loss kernels: a launch a peer (rows split over the batch) ----
    if train:
        v = cfg.num_classes if small else cfg.padded_vocab
        text = 1 if small else s - cfg.num_patches
        v_local = v if small else math.ceil(    # the btv hint
            v / _tp_ways("btv", (b, text, v), tp, tp_size))
        rows = b * text / batch_ways / peers_here   # a launch
        comp = extra.get("compression", "none")
        dist = extra.get("distill_loss", "mse")
        names = ["fused_cross_entropy_parts", "fused_cross_entropy_grad"]
        if mode == "codist" and comp in ("none", "bf16"):
            names = (["fused_ce_distill_parts", "fused_ce_distill_grad"]
                     + (n_models - 2) * (
                         ["fused_distill_loss", "fused_distill_mse_grad"]
                         if dist == "mse" else
                         ["fused_distill_kl_parts", "fused_distill_kl_grad"]))
        for name in names:
            byt, fl = loss_kernel_io(name, int(rows), v_local, act,
                                     mode=dist)
            out.add("kernel", name, fl * peers_here, byt * peers_here,
                    peers_here)
    if paged:
        _paged_kernels(out, cfg, paged, act)

    # ---- the optimizer; the arguments a device holds ----
    local = {p: math.prod(sh.local_shape(full(shp), specs[p], mesh))
             for p, (shp, _) in leaves.items()}
    n_local = sum(local.values())
    p_bytes = sum(n * leaves[p][1] for p, n in local.items())
    if train:       # params, their gradients and the moments
        opt = variant.get("optimizer", "sgdm")
        odt = nbytes(variant.get("opt_dtype", pdt))
        moments = 2 if opt == "adamw" else 1
        out.argument_bytes = 2 * p_bytes + n_local * moments * odt
        out.add("other", "optimizer", _OPT_FLOPS[opt] * n_local,
                3 * p_bytes + n_local * 2 * moments * odt)
    else:
        out.argument_bytes = p_bytes
    if not small:
        out.temp_bytes = _activation_bytes(cfg, shape, b, s, batch_ways, k,
                                           remat, act, tp, tp_size, train)

    # ---- collectives ----
    if mesh.size > 1:
        _collectives(out, cfg, shape, mode, mesh, specs, leaves, batch_axes,
                     stacked, n_models, fsdp, k, act, walk, batch_ways,
                     extra, remat, small)
    return out


def _paged_kernels(out: StepCost, cfg: ModelConfig, paged: Dict,
                   act: int) -> None:
    """Rows 1 and 2 (bf16 pools) or 1q and 4 (int8 / fp8) once a attention
    sub-layer of a fleet decode tick."""
    lengths = list(paged["lengths"])
    cdt = paged.get("cache_dtype", "bfloat16")
    quant = cdt in ("int8", "float8_e4m3fn")
    item = nbytes(cdt)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    byt, fl = paged_decode_io(lengths, cfg.num_heads, kvh, hd, item, act,
                              paged["max_blocks"], quant)
    name = "paged_attention_decode" + ("_quant" if quant else "")
    out.add("kernel", name, fl * n_attn, byt * n_attn, n_attn)
    row_b = kvh * hd * act
    sb = paged_scatter_io(len(lengths), row_b, paged["num_blocks"],
                          kvh * hd * item + 4 if quant else 0)
    name = "paged_scatter" + ("_quant" if quant else "")
    out.add("kernel", name, 0.0, sb * n_attn, n_attn)


def _tp_ways(kind: str, shape: Sequence[int], tp: Optional[str],
             tp_size: int) -> int:
    """The ways the hint of ``kind`` splits an activation of ``shape`` over
    the tp axis (1 where ``hint_spec`` leaves that axis out of it)."""
    spec = hint_spec(kind, shape, None, tp, tp_size)
    return tp_size if (tp and spec is not None
                       and tp in sh.spec_axes(spec)) else 1


def _activation_bytes(cfg, shape, b, s, batch_ways, k, remat, act, tp,
                      tp_size, train) -> float:
    """An estimate of the activations a device holds at the step's peak:
    for training, the residual stream saved at every layer (one (B, S, d)
    carry a layer under remat, d over tp where it divides: the
    ``btd_carry`` hint) plus one layer's working set (its projections and
    the (B, H, S, S) fp32 scores over tp) and the logits with their fp32
    gradient; for prefill one layer's working set and the logits of the
    last position; for decode the cache is the argument, and this the
    step's rows."""
    d, h = cfg.d_model, cfg.num_heads
    bl = b / batch_ways / (k if train else 1)
    if shape.kind == "decode":
        return float(bl * (d * 8 + cfg.padded_vocab) * act)
    text = s - cfg.num_patches
    layers = cfg.num_layers + cfg.encoder_layers
    per_layer = bl * s * d * act / _tp_ways("btd_carry", (b, s, d), tp,
                                            tp_size)
    work = bl * s * (4 * d + 3 * max(cfg.d_ff, 2 * d)) * act \
        + bl * h * s * s * 4 / _tp_ways("scores", (b, h, s, s), tp, tp_size)
    if not train:
        return float(work + bl * cfg.padded_vocab * act)
    saved = per_layer * layers * (1 if remat else 6)
    logits = bl * text * cfg.padded_vocab * (act + 4) / _tp_ways(
        "btv", (b, text, cfg.padded_vocab), tp, tp_size)
    return float(saved + work + logits)


def _collectives(out, cfg, shape, mode, mesh, specs, leaves, batch_axes,
                 stacked, n_models, fsdp, k, act, walk, batch_ways, extra,
                 remat, small) -> None:
    """The step's collectives from the placements (module docstring)."""
    sizes = mesh.shape
    dpp = mesh.size // sizes["pod"] if "pod" in sizes else 0
    train = shape.kind == "train"
    lead = 1 if stacked else 0
    groups: Dict[tuple, List[List[int]]] = {}

    def op(kind, axes, operand, line, result=None, reps=1):
        axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
        if not axes or operand <= 0:
            return
        if axes not in groups:
            groups[axes] = mesh.groups(axes)
        g = groups[axes]
        for _ in range(reps):
            out.collectives.ops.append(CollectiveOp(
                kind, int(operand if result is None else result),
                int(operand), g, _crosses_pods(g, dpp), line,
                _crosses_nodes(g)))

    expert_axis = None
    for path, (shp, item) in leaves.items():
        spec = specs[path]
        local = math.prod(sh.local_shape(
            (n_models, *shp) if stacked else shp, spec, mesh)) * item
        dims = [sh.axes_of(e) for e in spec[lead:]]
        scan = int(sh._scanned(path))
        # an expert stack (…, E, d, f) whose E dim is placed: expert
        # parallelism (its weights stay put)
        is_expert = path.endswith(("ffn/w_gate", "ffn/w_up", "ffn/w_down")) \
            and len(shp) >= 3 + scan
        if is_expert and dims[scan]:
            expert_axis = dims[scan]
        # FSDP: gather before each use, reduce-scatter the gradient
        if fsdp and any(fsdp in d for d in dims) and not (
                is_expert and fsdp in dims[scan]):
            ways = sizes[fsdp]
            reps = k if train else 1
            op("all-gather", (fsdp,), local, f"{path} fsdp fwd",
               local * ways, reps)
            if train:
                op("all-gather", (fsdp,), local, f"{path} fsdp bwd",
                   local * ways, reps)
                op("reduce-scatter", (fsdp,), local * ways, f"{path} grad",
                   local, reps)
        if train:   # the gradient over the batch axes that share the leaf
            held = {a for d in dims for a in d}
            sync = tuple(a for a in batch_axes if a not in held
                         and not (stacked and a == "pod"))
            op("all-reduce", sync, local, f"{path} grad sync")
    # TP: an all-reduce after each row-parallel product (its weight's
    # contraction dim over "model"), and of its input gradient backward
    if "model" in sizes and not small:
        reps = 1 + ((1 + (1 if remat else 0)) if train else 0)
        for g in walk.out:
            if g.split != "w" or g.leaf.endswith(("/wq", "/wk", "/wv",
                                                  "embed/tokens")):
                continue
            spec = specs[g.leaf][lead:]
            if len(spec) >= 2 and "model" in sh.axes_of(spec[-2]):
                op("all-reduce", ("model",), g.c / batch_ways,
                   f"{g.part} tp", reps=reps * g.count)
    # expert parallelism: each device's capacity buffers (G, E, C, d) to
    # the experts' devices and back (``models/moe.py`` ``_moe_experts``),
    # a routing group a batch row of s tokens (one token a slot in a
    # decode step): C the GShard capacity of a train step, s (no drops)
    # in serving; two exchanges a forward, two a backward, two more in
    # the remat forward, a microbatch's groups at a time
    if expert_axis and getattr(cfg, "moe", None) is not None:
        from repro_torch.models.moe import _capacity
        s = 1 if shape.kind == "decode" else shape.seq_len
        groups_l = shape.global_batch // batch_ways // (k if train else 1)
        cap = _capacity(cfg.moe, s, 1.25 if train else 0.0)
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        per_mb = 2 * (2 + (1 if remat else 0)) if train else 2
        op("all-to-all", expert_axis, groups_l * cfg.moe.num_experts * cap
           * cfg.d_model * act, "moe dispatch / combine",
           reps=per_mb * n_moe * (k if train else 1))
    # the codist wire: each device receives the other pods' predictions of
    # its rows, in the layout the wire has on it: a logits-shaped wire
    # (none, bf16, subsample) keeps the logits' V over tp (the "btv" hint),
    # so a device sends and receives its V / tp columns; the top-k wire is
    # whole on every device of a pod (the "wire" hint). A classifier's
    # wire is one row an example, its classes whole on every device (the
    # conv nets' logits come off local rows, the MLP's off replicated
    # weights)
    if train and mode == "codist" and "pod" in batch_axes:
        comp = extra.get("compression", "none")
        sub = extra.get("subsample", 0)
        if small:
            b_pred = _classifier_wire_bits(cfg.num_classes, comp,
                                           extra.get("topk", 64))
            peer_rows = shape.global_batch // n_models
            if comp == "subsample" and sub:
                b_pred = b_pred * min(sub, peer_rows) / peer_rows
        else:
            # the logits' own bits (a bf16 model sends bf16 logits); the
            # top-k wire's values at those bits, its indices at 32
            text = shape.seq_len - cfg.num_patches
            b_pred = cm.prediction_bits_lm(cfg, text, 8 * act, comp,
                                           extra.get("topk", 64), sub)
            if comp != "topk":
                v = cfg.padded_vocab
                ways = _tp_ways("btv", (shape.global_batch, text, v),
                                "model" if "model" in sizes else None,
                                sizes.get("model", 1))
                b_pred = b_pred * math.ceil(v / ways) / v
        rows = shape.global_batch // batch_ways
        op("all-gather", ("pod",), (n_models - 1) * b_pred * rows / 8,
           f"codist wire ({comp})")


def _classifier_wire_bits(num_classes: int, comp: str, topk: int) -> float:
    """A classifier's wire a row (one logit vector an example,
    ``comm_model.prediction_bits_classifier``): fp32 logits for none and
    subsample, bf16 for bf16, and for top-k the k largest (at most the
    classes) with their int32 indices."""
    if comp == "topk":
        return min(topk, num_classes) * (32 + 32)
    return cm.prediction_bits_classifier(num_classes,
                                         16 if comp == "bf16" else 32)
