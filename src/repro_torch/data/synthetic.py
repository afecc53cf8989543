"""Deterministic synthetic LM data: a random first-order Markov chain.

The reference's construction (``MarkovLM``, ``make_lm_batch``,
``lm_batch_iterator``), driven by seeded ``torch.Generator``s instead of
``jax.random`` keys. Its streams therefore differ from the reference's for
the same seed; parity tests feed both sides the same numpy batches instead.

* Learnable structure: token streams follow a fixed random transition
  matrix (``randn(v, v) / concentration`` logits), so losses fall.
* Coordinated sampling (Section 3): a batch is a pure function of
  ``(seed, step [, group])``. With the group dropped every codistilling
  peer draws the identical batch without communication.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import torch

from repro_torch import resolve_device


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    return gen


@dataclass(frozen=True)
class MarkovLM:
    """First-order Markov chain over ``vocab`` tokens; ``concentration``
    sets how predictable transitions are (lower => more learnable)."""
    vocab: int
    seed: int = 0
    concentration: float = 0.3
    effective_vocab: int = 0  # 0 => vocab (cap for huge-vocab configs)

    def transition_logits(self, device="cuda") -> torch.Tensor:
        v = self.effective_vocab or self.vocab
        dev = resolve_device(device)
        return torch.randn((v, v), generator=_generator(self.seed, dev),
                           device=dev) / self.concentration

    def sample(self, generator: torch.Generator, batch: int,
               seq_len: int) -> torch.Tensor:
        """(batch, seq_len) int32 token streams drawn from ``generator``
        (on the generator's device): uniform first token, then each next
        token categorical on its row of the transition logits (Gumbel-max,
        as ``jax.random.categorical`` samples)."""
        dev = generator.device
        v = self.effective_vocab or self.vocab
        logits = self.transition_logits(dev)
        tok = torch.randint(0, v, (batch,), generator=generator, device=dev)
        u = torch.rand((seq_len - 1, batch, v), generator=generator,
                       device=dev)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out = [tok]
        for s in range(seq_len - 1):
            tok = (logits[tok] + gumbel[s]).argmax(dim=-1)
            out.append(tok)
        return torch.stack(out, dim=1).to(torch.int32)


def _batch_seed(seed: int, step: int, group: Optional[int]) -> int:
    """A distinct generator seed per (seed, step[, group])."""
    s = (seed * 1_000_003 + step) * 7_919
    return s + (0 if group is None else 7_919 + group)


def make_lm_batch(task: MarkovLM, batch: int, seq_len: int, step: int,
                  group: Optional[int] = None, seed: int = 0,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """(tokens, labels = next token, mask), a pure function of (seed,
    step[, group])."""
    dev = resolve_device(device)
    toks = task.sample(_generator(_batch_seed(seed, step, group), dev),
                       batch, seq_len + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": torch.ones((batch, seq_len), dtype=torch.float32,
                               device=dev)}


def lm_batch_iterator(task: MarkovLM, batch: int, seq_len: int,
                      coordinated: bool, group: int = 0, seed: int = 0,
                      device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite iterator; ``coordinated=True`` ignores the group (the same
    batches for every peer, the prediction-exchange requirement)."""
    step = 0
    g = None if coordinated else group
    while True:
        yield make_lm_batch(task, batch, seq_len, step, g, seed, device)
        step += 1


def classification_batch(generator: torch.Generator, batch: int, dim: int,
                         num_classes: int, noise: float = 1.0,
                         image: bool = False, image_size: int = 32
                         ) -> Dict[str, torch.Tensor]:
    """Gaussian-cluster classification data drawn from ``generator`` (on
    its device): class centres N(0, 2^2), int32 labels, features centre +
    N(0, noise^2); with ``image`` the features are tiled into (B, side,
    side, 3) NHWC images instead, as the reference shapes them."""
    dev = generator.device
    centers = torch.randn((num_classes, dim), generator=generator,
                          device=dev) * 2.0
    labels = torch.randint(0, num_classes, (batch,), generator=generator,
                           device=dev, dtype=torch.int32)
    x = centers[labels.long()] + noise * torch.randn(
        (batch, dim), generator=generator, device=dev)
    out: Dict[str, torch.Tensor] = {"labels": labels}
    if image:
        side = image_size
        need = side * side * 3
        reps = -(-need // dim)
        out["images"] = x.repeat(1, reps)[:, :need].reshape(batch, side,
                                                            side, 3)
    else:
        out["features"] = x
    return out
