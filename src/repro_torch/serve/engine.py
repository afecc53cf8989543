"""Batched serving engine: prefill + decode over a dense per-call cache.

Serves a single model (codistillation is a training mechanism; only one
model is needed at inference). Greedy and temperature sampling, batches of
equal prompt length, and — via ``prompt_lens`` — ragged batches of mixed
prompt lengths: rows are prefilled in exact-length groups (no pad token
ever enters a cache) and then decoded together at per-row cache positions,
so ragged generation is token-identical to per-request generation at
temperature 0, the invariant the continuous-batching fleet
(``repro_torch.serve.fleet``) is built on.

The model is a decoder LM (``LM``: token prompts, and for a VLM config
precomputed ``patches`` whose prefix takes the first cache positions) or
the encoder-decoder ``EncDecLM``, whose batch also holds the encoder's
input, ``frames`` or ``src_tokens``; the whole batch dict goes to the
model's prefill. Ragged batches take token-only LM inputs, as the
reference asserts.

The reference jits its prefill and decode; the port runs them eagerly
(``prefill``, ``decode``), the cache updated in place. At a
temperature above 0 the reference splits its key once a step; the port
draws every step from one ``torch.Generator`` seeded from ``seed``, so the
two sample different tokens from the same seed.

Its dtype policy (``default_cache_dtype``, ``resolve_cache_dtype``) is the
fleet's too, which resolves ``--cache-dtype`` through it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.kernels.paged_cache import is_quantized_dtype

PyTree = Any


def default_cache_dtype(device="cuda") -> torch.dtype:
    """bf16 KV caches on the card (halves the dominant serving tensor);
    fp32 on the CPU, where the tests want reference numerics — the
    reference's TPU / interpret split."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


_NAMES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
          "fp32": torch.float32, "float32": torch.float32,
          "fp16": torch.float16, "float16": torch.float16,
          "int8": torch.int8, "fp8": torch.float8_e4m3fn,
          "float8_e4m3fn": torch.float8_e4m3fn}


def resolve_cache_dtype(name: Optional[str], device="cuda") -> torch.dtype:
    """CLI spelling -> dtype; None/'auto' defers to ``default_cache_dtype``.
    The quantized spellings (``int8``, ``fp8`` / ``float8_e4m3fn``) resolve
    to paged-pool storage dtypes, which only the fleet serves."""
    if name is None or name == "auto":
        return default_cache_dtype(device)
    if name not in _NAMES:
        raise ValueError(f"unknown cache dtype {name!r}; valid names: auto, "
                         f"{', '.join(_NAMES)}")
    return _NAMES[name]


@dataclass
class GenerationResult:
    tokens: torch.Tensor     # (B, prompt + generated)
    prompt_len: int
    logprobs: Optional[torch.Tensor] = None
    # ragged batches: per-row true prompt lengths (tokens[r, :prompt_lens[r]]
    # is the prompt, tokens[r, prompt_len:] the generated continuation)
    prompt_lens: Optional[List[int]] = None


class Engine:
    """Batched ``generate`` of one model on ``device`` (the card unless the
    caller asks for the CPU); ``cache_dtype`` None takes
    ``default_cache_dtype``. The quantized pool dtypes are refused: only
    the fleet serves them."""

    def __init__(self, model, params: PyTree, cache_dtype=None,
                 device="cuda"):
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self.cache_dtype = (default_cache_dtype(self.device)
                            if cache_dtype is None else cache_dtype)
        if is_quantized_dtype(self.cache_dtype):
            raise ValueError(
                f"cache_dtype {str(self.cache_dtype).replace('torch.', '')} "
                "is a quantized paged-pool dtype: only the fleet engine "
                "(repro_torch.serve.fleet) serves quantized KV — the dense "
                "Engine cache supports bf16/fp16/fp32")

    @torch.no_grad()
    def generate(self, batch: Dict, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 prompt_lens: Optional[List[int]] = None) -> GenerationResult:
        """batch: ``{"tokens": (B, prompt_len)}`` prompts on the engine's
        device; for a VLM config its ``patches`` (B, num_patches, d), and
        for an enc-dec model its ``frames`` (B, T, d) or ``src_tokens``
        (B, T). ``prompt_lens``: per-row true lengths of a RIGHT-PADDED
        mixed-length batch — row r's prompt is ``tokens[r, :prompt_lens[r]]``
        and the pad columns are never read (grouped exact-length prefill,
        per-row decode positions), so the tokens equal per-request
        generation at temperature 0."""
        if prompt_lens is not None:
            return self._generate_ragged(batch, max_new_tokens, temperature,
                                         seed, prompt_lens)
        prompt = batch["tokens"]
        _b, prompt_len = prompt.shape
        # VLM: the patch prefix takes the cache positions before the prompt
        prefix = getattr(self.model.cfg, "num_patches", 0) or 0
        if "patches" not in batch:
            prefix = 0
        logits, cache = self.model.prefill(
            self.params, batch, prefix + prompt_len + max_new_tokens,
            self.cache_dtype)
        gen = self._generator(seed)
        tok = self._select(logits[:, -1], temperature, gen).to(prompt.dtype)
        out = [prompt, tok]
        for i in range(1, max_new_tokens):
            logits, cache = self.model.decode(self.params, cache, tok,
                                              prefix + prompt_len + i - 1)
            tok = self._select(logits[:, -1], temperature, gen).to(prompt.dtype)
            out.append(tok)
        return GenerationResult(torch.cat(out, dim=1), prompt_len)

    def _generate_ragged(self, batch: Dict, max_new_tokens: int,
                         temperature: float, seed: int,
                         prompt_lens: List[int]) -> GenerationResult:
        if (getattr(self.model.cfg, "is_encdec", False)
                or set(batch) & {"patches", "frames", "src_tokens"}):
            raise ValueError("ragged batching supports token-only LM inputs")
        if self.model.cfg.sliding_window > 0:
            raise ValueError("ragged batching needs a full-length cache "
                             "(no ring buffer)")
        prompt = batch["tokens"]
        b, max_len = prompt.shape
        lens = [int(x) for x in prompt_lens]
        if len(lens) != b or not all(1 <= n <= max_len for n in lens):
            raise ValueError(f"prompt_lens {lens} do not fit tokens "
                             f"{tuple(prompt.shape)}")
        cap = max_len + max_new_tokens
        dev = prompt.device

        # group rows by true length: each group prefills its EXACT-length
        # slice (pads never enter the caches)
        groups: Dict[int, List[int]] = {}
        for r, n in enumerate(lens):
            groups.setdefault(n, []).append(r)
        order: List[int] = []
        caches, first_logits = [], []
        for n in sorted(groups):
            rows = groups[n]
            order.extend(rows)
            idx = torch.tensor(rows, device=dev)
            logits, cache = self.model.prefill(self.params, prompt[idx, :n],
                                               cap, self.cache_dtype)
            caches.append(cache)
            first_logits.append(logits[:, -1])
        # merge the group caches along the batch axis, back to row order
        inv = torch.argsort(torch.tensor(order, device=dev))
        cache = {sub: {k: torch.cat([c[sub][k] for c in caches], dim=1)[:, inv]
                       for k in caches[0][sub]} for sub in caches[0]}
        del caches
        gen = self._generator(seed)
        tok = self._select(torch.cat(first_logits)[inv], temperature,
                           gen).to(prompt.dtype)
        out = [prompt, tok]
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        for i in range(1, max_new_tokens):
            # per-row absolute position of `tok`
            logits, cache = self.model.decode(self.params, cache, tok,
                                              lens_t + (i - 1))
            tok = self._select(logits[:, -1], temperature, gen).to(prompt.dtype)
            out.append(tok)
        return GenerationResult(torch.cat(out, dim=1), max_len,
                                prompt_lens=lens)

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    @staticmethod
    def _select(logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
        """(B, V) logits -> (B, 1) tokens: the argmax at temperature 0, else
        a draw from softmax(logits / temperature) in fp32."""
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)
