"""The bf16 flash attention kernels' arithmetic, emulated on the CPU.

``csrc/flash_attention.cu`` runs bf16 attention on the tensor cores: the
scores are the unscaled bf16 q k^T with fp32 accumulation, scaled in fp32
afterwards; the online softmax keeps an fp32 (m, l, acc) state over tiles
of BK columns; P enters P V as two bf16 operands, p_hi = bf16(p) and
p_lo = bf16(p - p_hi), both accumulated in fp32; the output is rounded to
bf16 once. The card cannot be reached from these tests, so a plain
emulation of that arithmetic, written here, is held against
``flash_attention_plain`` (a dense fp32 softmax rounded to bf16 once) with
the per-element criterion that ``chip_smoke.py``'s ``check_flash`` applies
to the kernel: each output element within one bf16 ulp of its own magnitude
plus 2^-16 max|out|. A second case shows that a single bf16 P misses that
criterion, which is why the kernels split P.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention_plain
from repro_torch.kernels.flash_attention import NEG, attention_mask

# the criterion's floor, relative to max|out| (chip_smoke.FLASH_FLOOR_REL)
FLOOR_REL = 2.0 ** -16


def misses(k: torch.Tensor, p: torch.Tensor) -> tuple[int, float]:
    """(count, worst ratio) of the elements of ``k`` farther from ``p``
    than one bf16 ulp of p's element plus FLOOR_REL * max|p|."""
    kf, pf = k.float(), p.float()
    floor = FLOOR_REL * float(pf.abs().max())
    mant, exp = torch.frexp(pf.abs())
    ulp = torch.where(mant > 0, torch.ldexp(torch.ones_like(mant), exp - 8),
                      torch.zeros_like(mant))
    ratio = (kf - pf).abs() / (ulp + floor)
    return int((ratio > 1).sum()), float(ratio.max())


def emulate(q, k, v, causal, window, bk, split_p=True):
    """The kernels' bf16 arithmetic over tiles of ``bk`` columns."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    qf = q.float().reshape(b, s, kvh, g, hd)
    kf, vf = k.float(), v.float()
    keep = attention_mask(s, t, causal, window, q.device)
    m = torch.full((b, kvh, g, s), NEG)
    l = torch.zeros((b, kvh, g, s))
    acc = torch.zeros((b, kvh, g, s, hd))
    for c0 in range(0, t, bk):
        c1 = min(c0 + bk, t)          # columns past T do not exist
        sc = torch.einsum("bskgd,btkd->bkgst", qf, kf[:, c0:c1]) * scale
        sc = torch.where(keep[:, c0:c1], sc, NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        p_hi = p.bfloat16().float()
        pv = torch.einsum("bkgst,btkd->bkgsd", p_hi, vf[:, c0:c1])
        if split_p:
            p_lo = (p - p_hi).bfloat16().float()
            pv = pv + torch.einsum("bkgst,btkd->bkgsd", p_lo, vf[:, c0:c1])
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).bfloat16()


def inputs(b, s, t, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
            for shape in ((b, s, h, hd), (b, t, kvh, hd), (b, t, kvh, hd))]


# (b, s, t, h, kvh, hd, causal, window, bk): causal at the wgmma kernel's
# 128-column tiles, a causal window at the mma.sync kernel's 64, non-causal
# T != S, and rows masked in every column (S > T, window 16)
SHAPES = [
    (1, 512, 512, 4, 2, 64, True, 0, 128),
    (1, 256, 256, 4, 2, 128, True, 48, 64),
    (2, 96, 200, 4, 2, 128, False, 0, 128),
    (1, 200, 64, 4, 2, 32, True, 16, 64),
]


@pytest.mark.parametrize("b,s,t,h,kvh,hd,causal,window,bk", SHAPES)
def test_split_p_meets_the_per_element_check(b, s, t, h, kvh, hd, causal,
                                             window, bk):
    q, k, v = inputs(b, s, t, h, kvh, hd, seed=s + t + hd)
    got = emulate(q, k, v, causal, window, bk)
    want = flash_attention_plain(q, k, v, causal, window)
    assert got.dtype == want.dtype == torch.bfloat16
    bad, worst = misses(got, want)
    assert bad == 0, f"{bad} elements beyond the check, worst ratio {worst:.2f}"


def test_single_bf16_p_misses_the_per_element_check():
    b, s, t, h, kvh, hd, causal, window, bk = SHAPES[0]
    q, k, v = inputs(b, s, t, h, kvh, hd, seed=s + t + hd)
    want = flash_attention_plain(q, k, v, causal, window)
    bad, worst = misses(emulate(q, k, v, causal, window, bk, split_p=False),
                        want)
    assert bad > 100 and worst > 4, (bad, worst)
    assert misses(emulate(q, k, v, causal, window, bk), want)[0] == 0
