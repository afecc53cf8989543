"""ResNet / Wide-ResNet image classifiers with GroupNorm — the paper's own
vision workloads (resnet50, wrn28x10).

The parameter tree is the reference's, leaf for leaf: one flat dict a block
(``s{stage}b{block}``: ``conv1``..``conv3``, ``gn{i}_scale`` / ``gn{i}_bias``
and an optional 1x1 ``proj``), convolution weights in its HWIO layout
``(kh, kw, cin, cout)``, the head ``(C, num_classes)``. Images arrive as the
reference's NHWC ``(B, H, W, 3)``. Inside the forward the activations are
NCHW tensors in channels-last memory, which is the same NHWC bytes, so that
``F.conv2d`` (cuDNN on the card) and ``F.group_norm`` take them as they are;
each weight is viewed as OIHW. The reference computes its convolutions with
``lax.conv_general_dilated`` and its norm with jnp, outside any Pallas
kernel, so these library calls are its counterparts as ``torch.matmul`` is
for its einsums.

* ``"SAME"`` padding is XLA's: a total of ``max((ceil(H/s) - 1) s + k - H,
  0)`` split with the smaller half BEFORE. A 3x3 stride-2 convolution of an
  even input pads 0 before and 1 after, which ``padding=1`` would shift by
  a pixel, so uneven pads go through ``F.pad``.
* GroupNorm is the reference's ``_gn``: ``min(groups, C)`` groups stepped
  down until they divide C, fp32 statistics, the biased variance, eps 1e-5.
* ``forward(..., split=(i, n))`` zeroes all but the i-th of n channel
  groups (``w = C // n``) after stage 0: the Section-5.1 views. The train
  step never passes it.

The reference's resnet50 keeps its quirks: a 3x3 stride-1 stem and no
max-pool, so stage 0 runs at the full image size.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.common import dense_init_

PyTree = Any


@dataclass(frozen=True)
class ConvConfig:
    name: str
    kind: str                  # 'resnet' | 'wideresnet'
    depths: Tuple[int, ...]    # blocks per stage
    widths: Tuple[int, ...]    # channels per stage
    bottleneck: bool
    num_classes: int
    image_size: int
    groups: int = 8            # groupnorm groups
    source: str = ""

    @property
    def family(self) -> str:
        return "conv"


def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
               device) -> torch.Tensor:
    """He-normal HWIO weights, std sqrt(2 / fan_in)."""
    std = (2.0 / (kh * kw * cin)) ** 0.5
    return torch.randn((kh, kw, cin, cout), generator=gen,
                       device=device) * std


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" (before, after) padding of one spatial dim."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, C, H, W) channels-last, w HWIO -> "SAME" convolution."""
    kh, kw = w.shape[0], w.shape[1]
    (t, b), (l, r) = (_same_pads(x.shape[2], kh, stride),
                      _same_pads(x.shape[3], kw, stride))
    pad = 0
    if (t, l) == (b, r):
        pad = (t, l)
    else:
        x = F.pad(x, (l, r, t, b))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=pad)


def _gn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    c = x.shape[1]
    g = min(groups, c)
    while c % g:
        g -= 1
    y = F.group_norm(x.float(), g, scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def _init_block(gen: torch.Generator, cin: int, cout: int, bottleneck: bool,
                device) -> Dict[str, torch.Tensor]:
    p: Dict[str, torch.Tensor] = {}
    if bottleneck:
        mid = cout // 4
        p["conv1"] = _conv_init(gen, 1, 1, cin, mid, device)
        p["conv2"] = _conv_init(gen, 3, 3, mid, mid, device)
        p["conv3"] = _conv_init(gen, 1, 1, mid, cout, device)
        dims = (mid, mid, cout)
    else:
        p["conv1"] = _conv_init(gen, 3, 3, cin, cout, device)
        p["conv2"] = _conv_init(gen, 3, 3, cout, cout, device)
        dims = (cout, cout)
    for i, d in enumerate(dims, 1):
        p[f"gn{i}_scale"] = torch.ones(d, device=device)
        p[f"gn{i}_bias"] = torch.zeros(d, device=device)
    if cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout, device)
    return p


def _block_fwd(p: Dict[str, torch.Tensor], x: torch.Tensor, stride: int,
               cfg: ConvConfig) -> torch.Tensor:
    g = cfg.groups
    if "conv3" in p:  # bottleneck
        h = F.relu(_gn(_conv(x, p["conv1"]), p["gn1_scale"], p["gn1_bias"], g))
        h = F.relu(_gn(_conv(h, p["conv2"], stride), p["gn2_scale"],
                       p["gn2_bias"], g))
        h = _gn(_conv(h, p["conv3"]), p["gn3_scale"], p["gn3_bias"], g)
    else:
        h = F.relu(_gn(_conv(x, p["conv1"], stride), p["gn1_scale"],
                       p["gn1_bias"], g))
        h = _gn(_conv(h, p["conv2"]), p["gn2_scale"], p["gn2_bias"], g)
    sc = x
    if "proj" in p:
        sc = _conv(sc, p["proj"], stride)
    elif stride != 1:
        sc = sc[:, :, ::stride, ::stride]
    return F.relu(h + sc)


@dataclass(frozen=True)
class ConvNet:
    cfg: ConvConfig

    def init(self, generator: torch.Generator, device="cuda") -> PyTree:
        """fp32 parameters from ``generator`` (on ``device``): He-normal
        convolutions, GroupNorm scale 1 and bias 0, a truncated-normal
        fan-in head, as the reference draws them (empty stand-ins on
        ``device="meta"``)."""
        cfg = self.cfg
        dev = resolve_device(device, meta=True)
        stem_out = (cfg.widths[0] if not cfg.bottleneck
                    else max(16, cfg.widths[0] // 4))
        params: Dict = {
            "stem": _conv_init(generator, 3, 3, 3, stem_out, dev),
            "stem_gn_scale": torch.ones(stem_out, device=dev),
            "stem_gn_bias": torch.zeros(stem_out, device=dev),
        }
        cin = stem_out
        for s, (depth, width) in enumerate(zip(cfg.depths, cfg.widths)):
            for b in range(depth):
                params[f"s{s}b{b}"] = _init_block(generator, cin, width,
                                                  cfg.bottleneck, dev)
                cin = width
        params["head"] = dense_init_(
            torch.empty((cin, cfg.num_classes), device=dev), cin, generator)
        return params

    def forward(self, params: PyTree, batch: Dict,
                split: Optional[Tuple[int, int]] = None,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch["images"] (B, H, W, 3) -> (fp32 logits (B, classes), aux 0).
        ``split=(i, n)`` keeps only the i-th of n channel groups after stage
        0. ``remat`` is accepted and ignored, as in the reference. DTensor
        images (a batch placed on a mesh) run on each rank's own rows
        (``_forward_placed``)."""
        images = batch["images"]
        if type(images) is not torch.Tensor and hasattr(images,
                                                        "device_mesh"):
            logits = _forward_placed(self.cfg, params, images, split)
        else:
            logits = _forward(self.cfg, params, images, split)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)


def _forward(cfg: ConvConfig, params: PyTree, images: torch.Tensor,
             split: Optional[Tuple[int, int]]) -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)              # NCHW view of NHWC bytes
    x = F.relu(_gn(_conv(x, params["stem"]), params["stem_gn_scale"],
                   params["stem_gn_bias"], cfg.groups))
    for s, depth in enumerate(cfg.depths):
        for b in range(depth):
            stride = 2 if (s > 0 and b == 0) else 1
            x = _block_fwd(params[f"s{s}b{b}"], x, stride, cfg)
        if s == 0 and split is not None:
            i, n = split
            c = x.shape[1]
            w = c // n
            mask = torch.zeros(c, dtype=x.dtype, device=x.device)
            mask[i * w:(i + 1) * w] = 1.0
            x = x * mask[:, None, None]
    x = x.mean(dim=(2, 3))
    return x.float() @ params["head"].float()


def _forward_placed(cfg: ConvConfig, params: PyTree, images,
                    split: Optional[Tuple[int, int]]):
    """``_forward`` on each rank's own rows of the DTensor ``images``
    (``common.on_local_rows``): every parameter whole (the rules replicate
    a conv net), the logits (B, classes) on the images' rows. Every layer
    acts on each example alone (the group norm's statistics are per
    example), so a rank's rows are the whole batch's; DTensor's own
    group-norm backward fails on split rows."""
    from repro_torch.models.common import on_local_rows
    from repro_torch.tree import tree_leaves, tree_map

    def fn(x, *ws):
        it = iter(ws)
        return _forward(cfg, tree_map(lambda _: next(it), params), x, split)
    return on_local_rows(fn, images, *tree_leaves(params))


def freeze_mask(params: PyTree, prefixes: Tuple[str, ...]) -> PyTree:
    """1.0 for trainable leaves, 0.0 for frozen ones: every leaf under a
    top-level key that starts with one of ``prefixes`` (stage prefixes,
    'stem')."""
    def tag(name, sub):
        v = 0.0 if any(name.startswith(p) for p in prefixes) else 1.0
        if isinstance(sub, dict):
            return {k: tag(name, s) for k, s in sub.items()}
        return v
    return {k: tag(k, v) for k, v in params.items()}
