"""Fused paged-attention decode: CUDA kernel wrapper + plain version.

One-token GQA decode for every slot straight off the block pool: the kernel
(``csrc/paged_attention.cu``) reads each live K/V block once through the
block table and folds it into an fp32 online softmax, so no gathered
``(S, MB*BS, KVh, hd)`` context ever exists. One CTA takes a run of
``blocks_per_split`` blocks of one slot for a group of KV heads (every KV
head where the shapes allow it): a producer warp streams the run's pool
blocks (or the group's rows of them) into a shared-memory ring with 1D bulk
copies while the consumer warps, one or more per KV head, keep q and the
accumulators in registers and merge their softmax states at the end of the
run. A second launch merges the runs of each slot. ``decode_head_groups``
sizes the head groups and ``decode_split_plan`` the runs, from the shapes
and the card's SM count alone, so the launch reads nothing back from the
device.

The plain version walks the same blocks with the same fp32 state (running
max, denominator, accumulator; ``NEG`` masking for positions past the
slot's length; ``l = max(l, 1e-30)``), vectorised over slots and heads. By
default it walks each slot's blocks in one sequence, as the reference does;
with ``blocks_per_split`` it runs each run of blocks apart and merges the
runs as the kernel does (M = max m_i, L = sum l_i e^(m_i - M), A = sum
acc_i e^(m_i - M), out = A / max(L, 1e-30)). The two differ only in
rounding.

Quantized pools (int8 / float8_e4m3fn, see ``paged_cache.quantize_rows``)
come with one fp32 scale per stored row, ``k_scale`` / ``v_scale`` (NB, BS);
both the kernel and the plain version dequantize each K/V row in fp32
(``k * k_scale[row]``) before its dot, as the reference's
``_decode_kernel_quant``. The quantized variant counts its launches apart
(``paged_attention_decode_quant``).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_cache import (_check_index, _require,
                                             _same_device, is_quantized_dtype)

NEG = -1e30

# the split plan: the hd-128 kernel fits two CTAs an SM (registers and
# ring), and several slots' runs aim at WAVES waves over the SMs
CTAS_PER_SM = 2
WAVES = 3
# the bytes of K/V stages a CTA's ring may hold (csrc/paged_attention.cu
# kRingBudget: two CTAs an SM)
RING_BUDGET = 100 * 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_POOL_CODES = {**_DTYPE_CODES, torch.int8: 3, torch.float8_e4m3fn: 4}


def decode_split_plan(slots: int, max_blocks: int, num_sms: int,
                      groups: int = 1) -> Tuple[int, int]:
    """(blocks per split, splits per slot) of the decode kernel's grid
    (splits x slots x ``groups`` head-group CTAs), from ints alone; the
    slots' lengths never enter, so the launch needs no value from the
    device. A lone slot's runs split its table evenly over one resident
    round (``CTAS_PER_SM`` CTAs on each of ``num_sms`` SMs, shared by its
    head groups). Several slots are ragged, so their runs are short enough
    for ``WAVES`` waves over the SMs and the live ones spread. One group
    gives the plan of the kernel without head groups."""
    for v in (slots, max_blocks, num_sms, groups):
        _require(type(v) is int and v > 0,
                 f"the split plan takes positive ints, got {v!r}")
    if slots == 1:
        bps = -(-max_blocks // max(1, CTAS_PER_SM * num_sms // groups))
    else:
        bps = max(1, max_blocks // -(-WAVES * num_sms // (slots * groups)))
    return bps, -(-max_blocks // bps)


def decode_head_groups(kvh: int, g: int, hd: int, block_size: int,
                       elem_size: int, quantized: bool) -> int:
    """The KV heads one CTA of the decode takes, a divisor of ``kvh``.
    Every KV head wherever one CTA holds them all — at most 8 KV heads
    (16 at G <= 2), a warp or more each, and a K and a V block within the
    ring's shared memory; that is every config of the repo but
    qwen1.5-4b. Else the most of 8, 4 and 2 that divides ``kvh`` and whose
    K and V rows (and scale rows) fit the ring ``RING_BUDGET`` twice, so
    that a stage is in flight behind the one being read; else 1."""
    for v in (kvh, g, hd, block_size, elem_size):
        _require(type(v) is int and v > 0,
                 f"the head-group plan takes positive ints, got {v!r}")
    if (kvh <= (8 if g > 2 else 16)
            and 2 * block_size * kvh * hd * elem_size + 8 * block_size
            <= 200 * 1024):
        return kvh

    def stage(n):
        raw = 2 * block_size * n * hd * elem_size + (8 * block_size
                                                      if quantized else 0)
        return -(-raw // 128) * 128

    return next((n for n in (8, 4, 2)
                 if kvh % n == 0 and 2 * stage(n) <= RING_BUDGET), 1)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _walk(qf, k_pool, v_pool, table, lengths, n_live, k_scale, v_scale,
          m_lo: int, m_hi: int):
    """The fp32 online-softmax state (m, l, acc) of every slot over its
    live blocks in [m_lo, m_hi)."""
    s, kvh, g, hd = qf.shape
    bs = k_pool.shape[1]
    dev = qf.device
    m = torch.full((s, kvh, g), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((s, kvh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((s, kvh, g, hd), dtype=torch.float32, device=dev)
    offs = torch.arange(bs, device=dev)
    for mi in range(m_lo, m_hi):
        blk = table[:, mi].long()
        k = k_pool[blk].float()                                  # (S, BS, KVh, hd)
        v = v_pool[blk].float()
        if k_scale is not None:
            k = k * k_scale[blk][..., None, None]
            v = v * v_scale[blk][..., None, None]
        sc = torch.einsum("skgd,sbkd->skgb", qf, k)              # (S, KVh, G, BS)
        pos = mi * bs + offs
        valid = pos[None, :] <= lengths[:, None]                 # (S, BS)
        sc = torch.where(valid[:, None, None, :], sc, NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l_new = l * alpha + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum("skgb,sbkd->skgd", p, v)
        live = (mi < n_live)[:, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    return m, l, acc


def paged_attention_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, table: torch.Tensor,
                                 lengths: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None,
                                 blocks_per_split: Optional[int] = None
                                 ) -> torch.Tensor:
    """Plain version of ``paged_attention_decode``: the block loop and fp32
    online-softmax state, vectorised over (slot, KV head, group); quantized
    rows are dequantized by their scale after the fp32 cast. With
    ``blocks_per_split``, each run of that many table entries keeps its own
    state and the runs that hold a live block are merged at the end."""
    s, h, hd = q.shape
    _, bs, kvh, _ = k_pool.shape
    mb = table.shape[1]
    g = h // kvh
    lengths = lengths.long()
    n_live = torch.clamp((lengths + bs) // bs, max=mb)
    qf = q.float().reshape(s, kvh, g, hd) * (hd ** -0.5)
    n_iter = int(n_live.max()) if s else 0
    args = (qf, k_pool, v_pool, table, lengths, n_live, k_scale, v_scale)
    if blocks_per_split is None:
        _m, l, acc = _walk(*args, 0, n_iter)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.reshape(s, h, hd).to(q.dtype)
    _require(blocks_per_split >= 1, "blocks_per_split must be >= 1")
    parts = [_walk(*args, lo, min(lo + blocks_per_split, n_iter))
             for lo in range(0, n_iter, blocks_per_split)]
    # a run with no live block keeps m = NEG, l = 0, acc = 0: weight 0
    m_all = torch.stack([p[0] for p in parts])                  # (n, S, KVh, G)
    w = torch.exp(m_all - m_all.amax(dim=0))
    big_l = (torch.stack([p[1] for p in parts]) * w).sum(dim=0)
    big_a = (torch.stack([p[2] for p in parts]) * w[..., None]).sum(dim=0)
    out = big_a / torch.clamp(big_l, min=1e-30)[..., None]
    return out.reshape(s, h, hd).to(q.dtype)


def paged_attention_decode(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           plan_slots: Optional[int] = None
                           ) -> torch.Tensor:
    """One-token decode for every slot, straight off the block pool.

    q (S, H, hd): the new token's roped query per slot; k_pool / v_pool
    (NB, BS, KVh, hd): the pools AFTER this step's scatter; table (S, MB)
    int32; lengths (S,) int32 = each slot's pre-step context length == the
    new token's position (valid keys are positions <= lengths[s]);
    k_scale / v_scale (NB, BS) fp32 row scales of quantized pools (both or
    neither; an fp32 or bf16 q). Returns (S, H, hd) in q's dtype.

    ``plan_slots`` makes the kernel split its work as
    ``decode_split_plan`` does for that many slots instead of S (the
    speculative verify passes the plain tick's slot count, so each of its
    pseudo-slots sums its softmax in the plain tick's order). The plain
    version on the CPU walks every slot in one run either way.
    """
    quantized = k_scale is not None
    _require(quantized == (v_scale is not None),
             "pass both scales or neither")
    scales = (k_scale, v_scale) if quantized else ()
    dev = _same_device(q, k_pool, v_pool, table, lengths, *scales)
    _require(q.dim() == 3, f"q must be (S, H, hd), got {tuple(q.shape)}")
    s, h, hd = q.shape
    _require(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
             f"k/v pools must share one (NB, BS, KVh, hd) shape, got "
             f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    nb, bs, kvh, pool_hd = k_pool.shape
    _require(pool_hd == hd, f"pool head_dim {pool_hd} != q head_dim {hd}")
    _require(h % kvh == 0, f"num_heads {h} is not a multiple of kv heads {kvh}")
    _require(k_pool.dtype == v_pool.dtype,
             f"k/v pool dtypes differ: {k_pool.dtype} vs {v_pool.dtype}")
    _require(q.dtype in _DTYPE_CODES and k_pool.dtype in _POOL_CODES,
             f"unsupported dtypes q={q.dtype} pool={k_pool.dtype} "
             "(q fp32/bf16/fp16; pools also int8/float8_e4m3fn)")
    _require(quantized == is_quantized_dtype(k_pool.dtype),
             f"{k_pool.dtype} pools take scales iff they are quantized")
    _require(not quantized or q.dtype != torch.float16,
             "quantized pools take an fp32 or bf16 q")
    for sc in scales:
        _require(sc.dtype == torch.float32
                 and tuple(sc.shape) == tuple(k_pool.shape[:2])
                 and sc.is_contiguous(),
                 f"scales must be contiguous {tuple(k_pool.shape[:2])} "
                 f"float32, got {tuple(sc.shape)} {sc.dtype}")
    _require(q.is_contiguous() and k_pool.is_contiguous()
             and v_pool.is_contiguous(), "q and the pools must be contiguous")
    _require(table.dim() == 2 and table.shape[0] == s and table.shape[1] > 0,
             f"table must be (S={s}, MB >= 1), got {tuple(table.shape)}")
    mb = table.shape[1]
    _check_index(table, (s, mb), "table")
    _check_index(lengths, (s,), "lengths")
    _require(plan_slots is None
             or (type(plan_slots) is int and plan_slots >= 1),
             f"plan_slots must be a positive int, got {plan_slots!r}")
    if _build.runs_plain(dev):
        return paged_attention_decode_plain(q, k_pool, v_pool, table, lengths,
                                            k_scale, v_scale)
    g = h // kvh
    es = k_pool.element_size()
    # the kernel's instances: 4 dims of a row per lane, G padded to 1, 2 or
    # 8; any KV head count (split into head groups where one CTA cannot
    # hold them all), with a ring of at least one K and V block of a head
    _require(hd in (32, 64, 128) and g <= 8,
             f"the CUDA decode takes head_dim 32/64/128 and G <= 8, got "
             f"head_dim {hd}, G {g}")
    _require(2 * bs * hd * es + 8 * bs <= 200 * 1024,
             f"a K and a V block of {bs} x {hd} {k_pool.dtype} (one KV head) "
             "do not fit the kernel's shared-memory ring")
    _require(not quantized or bs % 4 == 0,
             f"quantized pools need a block size that is a multiple of 4, "
             f"got {bs}")
    for t in (k_pool, v_pool, *scales):
        _require(t.data_ptr() % 16 == 0,
                 "the pools and scales must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if s == 0:
        return out
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    kvg = decode_head_groups(kvh, g, hd, bs, es, quantized)
    bps, nsplit = decode_split_plan(plan_slots or s, mb, _num_sms(index),
                                    kvh // kvg)
    part_ml = q.new_empty((2, s, nsplit, h), dtype=torch.float32)
    part_acc = q.new_empty((s, nsplit, h, hd), dtype=torch.float32)
    lib = _build.load("paged_attention")
    with torch.cuda.device(dev):
        rc = lib.repro_paged_attention_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            table.data_ptr(), lengths.data_ptr(), part_ml[0].data_ptr(),
            part_ml[1].data_ptr(), part_acc.data_ptr(), out.data_ptr(),
            s, h, kvh, hd, nb, bs, mb, bps, kvg, hd ** -0.5,
            _DTYPE_CODES[q.dtype], _POOL_CODES[k_pool.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    name = "paged_attention_decode" + ("_quant" if quantized else "")
    _build.check(lib, rc, name)
    _build.count_launch(name)
    return out
