"""Fused paged-attention decode: CUDA kernel wrapper + plain version.

One-token GQA decode for every slot straight off the block pool: the kernel
(``csrc/paged_attention.cu``) reads each live K/V block once through the
block table and folds it into an fp32 online softmax, so no gathered
``(S, MB*BS, KVh, hd)`` context ever exists. It splits each slot's blocks
over CTAs of ``BLOCKS_PER_SPLIT`` blocks and merges the splits' softmax
states at the end. The plain version walks the same blocks in one sequence
with the same fp32 state (running max, denominator, accumulator; ``NEG``
masking for positions past the slot's length; ``l = max(l, 1e-30)``),
vectorised over slots and heads; the two differ only in rounding where a
slot's context spans more than one split.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. Non-quantized pools only: the int8/fp8 pool
variant is the next slice's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_cache import _check_index, _require, _same_device

NEG = -1e30

# pool blocks per CTA of the kernel's split over each slot's context
BLOCKS_PER_SPLIT = 4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def paged_attention_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, table: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of ``paged_attention_decode``: the kernel's block loop
    and fp32 online-softmax state, vectorised over (slot, KV head, group)."""
    s, h, hd = q.shape
    _, bs, kvh, _ = k_pool.shape
    mb = table.shape[1]
    g = h // kvh
    dev = q.device
    lengths = lengths.long()
    n_live = torch.clamp((lengths + bs) // bs, max=mb)
    qf = q.float().reshape(s, kvh, g, hd) * (hd ** -0.5)
    m = torch.full((s, kvh, g), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((s, kvh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((s, kvh, g, hd), dtype=torch.float32, device=dev)
    offs = torch.arange(bs, device=dev)
    n_iter = int(n_live.max()) if s else 0
    for mi in range(n_iter):
        blk = table[:, mi].long()
        k = k_pool[blk].float()                                  # (S, BS, KVh, hd)
        v = v_pool[blk].float()
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
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(s, h, hd).to(q.dtype)


def paged_attention_decode(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """One-token decode for every slot, straight off the block pool.

    q (S, H, hd): the new token's roped query per slot; k_pool / v_pool
    (NB, BS, KVh, hd): the pools AFTER this step's scatter; table (S, MB)
    int32; lengths (S,) int32 = each slot's pre-step context length == the
    new token's position (valid keys are positions <= lengths[s]). Returns
    (S, H, hd) in q's dtype.
    """
    dev = _same_device(q, k_pool, v_pool, table, lengths)
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
    _require(q.dtype in _DTYPE_CODES and k_pool.dtype in _DTYPE_CODES,
             f"unsupported dtypes q={q.dtype} pool={k_pool.dtype} "
             "(fp32/bf16/fp16; quantized pools are the next slice's)")
    _require(q.is_contiguous() and k_pool.is_contiguous()
             and v_pool.is_contiguous(), "q and the pools must be contiguous")
    _require(table.dim() == 2 and table.shape[0] == s and table.shape[1] > 0,
             f"table must be (S={s}, MB >= 1), got {tuple(table.shape)}")
    mb = table.shape[1]
    _check_index(table, (s, mb), "table")
    _check_index(lengths, (s,), "lengths")
    if dev.type == "cpu":
        return paged_attention_decode_plain(q, k_pool, v_pool, table, lengths)
    out = torch.empty_like(q)
    if s == 0:
        return out
    g = h // kvh
    nsplit = -(-mb // BLOCKS_PER_SPLIT)
    part_ml = torch.empty((2, s, kvh, nsplit, g), dtype=torch.float32, device=dev)
    part_acc = torch.empty((s, kvh, nsplit, g, hd), dtype=torch.float32,
                           device=dev)
    lib = _build.load("paged_attention")
    with torch.cuda.device(dev):
        rc = lib.repro_paged_attention_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), lengths.data_ptr(), part_ml[0].data_ptr(),
            part_ml[1].data_ptr(), part_acc.data_ptr(), out.data_ptr(),
            s, h, kvh, hd, nb, bs, mb, BLOCKS_PER_SPLIT, hd ** -0.5,
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "paged_attention_decode")
    _build.count_launch("paged_attention_decode")
    return out
