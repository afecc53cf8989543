"""Synthetic multi-view task for the Section-5.1 n-way codistillation study.

Each sample's features are ``n_views`` noisy random PROJECTIONS of one
shared class-conditioned latent (the analogue of the channel splits of a
frozen pretrained bottleneck): every view alone is partially predictive,
views are correlated through the latent, and only their union approaches
the Bayes rate. The scenarios of the paper's Fig. 6: model i sees only view
(i mod n_views) ("enforced"), every model sees one view ("shared"), or all
views.

The reference draws its centroids, projections and samples from
``jax.random`` keys; here they come from seeded ``torch.Generator``s, so
the streams differ for the same seed. Parity tests feed the reference's
batches to both sides.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    return gen


@dataclass(frozen=True)
class MultiViewTask:
    n_views: int = 8
    view_dim: int = 8
    latent_dim: int = 24
    num_classes: int = 10
    latent_noise: float = 1.0
    noise: float = 1.0           # per-view observation noise
    seed: int = 0

    @property
    def dim(self) -> int:
        return self.n_views * self.view_dim

    def _gen(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(centroids (classes, latent) * 1.5, projections (views, latent,
        view_dim) with unit columns over the latent axis), from ``seed``."""
        gen = _generator(self.seed, device)
        centroids = torch.randn((self.num_classes, self.latent_dim),
                                generator=gen, device=device) * 1.5
        proj = torch.randn((self.n_views, self.latent_dim, self.view_dim),
                           generator=gen, device=device)
        proj = proj / torch.linalg.norm(proj, dim=1, keepdim=True)
        return centroids, proj

    def sample(self, generator: torch.Generator,
               batch: int) -> Dict[str, torch.Tensor]:
        """``batch`` samples from ``generator`` (on its device):
        ``features`` (B, dim) fp32 with the views side by side, int32
        ``labels``."""
        dev = generator.device
        centroids, proj = self._gen(dev)
        labels = torch.randint(0, self.num_classes, (batch,),
                               generator=generator, device=dev,
                               dtype=torch.int32)
        z = centroids[labels.long()] + self.latent_noise * torch.randn(
            (batch, self.latent_dim), generator=generator, device=dev)
        views = torch.einsum("bl,vld->vbd", z, proj)        # (V, B, view_dim)
        views = views + self.noise * torch.randn(
            views.shape, generator=generator, device=dev)
        feats = views.transpose(0, 1).reshape(batch, self.dim)
        return {"features": feats, "labels": labels}

    def view_mask(self, view: int, device="cuda") -> torch.Tensor:
        """(dim,) 0/1 mask exposing only one view: multiplied into the
        features."""
        m = torch.zeros(self.dim, device=resolve_device(device))
        m[view * self.view_dim:(view + 1) * self.view_dim] = 1.0
        return m


def multiview_batch(task: MultiViewTask, batch: int, step: int,
                    seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """The batch of ``step``: a pure function of (seed, step)."""
    gen = _generator((seed * 1_000_003 + step) * 7_919 + 1,
                     resolve_device(device))
    return task.sample(gen, batch)
