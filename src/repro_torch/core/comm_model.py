"""Section-3 analytical communication model.

All quantities are BITS PER ITERATION PER DEVICE over the *expensive* links
(inter-server in the paper; inter-pod here — intra-group communication is not
counted, exactly as Figure 1 only counts inter-server bytes).

  all_reduce (ring/tree):      C_AR   = 2 * b_model
  codist, checkpoints every T: C_ckpt = (n-1) * b_model / T
  codist, predictions every T: C_pred = (n-1) * b_pred * B / T

where b_model = bits of one parameter vector, b_pred = bits of the predictions
for ONE sample, B = per-device batch size (the paper's accounting) — for LM
workloads one "sample" is a sequence, so b_pred = seq_len * vocab * bits.

The paper's headline: ResNet50 (b_model = 8e8 bits, b_pred = 3.2e4 bits,
B = 256) => predictions every 5 iterations communicates ~1000x fewer bits than
all_reduce. The reference's ``test_comm_model.py`` asserts these exact
numbers. Pure Python: the reference's module, with ``param_bits_of`` reading
torch tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import CodistConfig, ModelConfig


@dataclass(frozen=True)
class CommCost:
    bits_per_iter_per_device: float
    scheme: str

    def ratio_vs(self, other: "CommCost") -> float:
        """How many times fewer bits this scheme communicates vs `other`."""
        if self.bits_per_iter_per_device == 0:
            return float("inf")
        return other.bits_per_iter_per_device / self.bits_per_iter_per_device


def allreduce_bits(b_model: float) -> CommCost:
    """Optimized ring/tree all_reduce: each device sends+receives ~2x the model."""
    return CommCost(2.0 * b_model, "all_reduce")


def codist_checkpoint_bits(b_model: float, n: int, period: int) -> CommCost:
    return CommCost((n - 1) * b_model / period, f"codist_ckpt_T{period}")


def codist_prediction_bits(b_pred: float, batch: int, n: int, period: int) -> CommCost:
    return CommCost((n - 1) * b_pred * batch / period, f"codist_pred_T{period}")


def bits_per_exchange_event(scheme: str, n: int, b_model: float = 0.0,
                            b_pred: float = 0.0, batch: int = 1) -> float:
    """Bits crossing the slow links for ONE exchange event.

    This is the event-based view the async runtime meters: one event is one
    peer's exchange step, in which it receives the (n-1) other replicas'
    payloads — predictions (``b_pred`` bits per sample, ``batch`` samples)
    or parameters (``b_model``); all_reduce's event is the per-step gradient
    ring (~2x the model per device). The per-iteration quantities above are
    this divided by the exchange period.
    """
    if scheme in ("all_reduce", "allreduce"):
        return 2.0 * b_model
    if scheme in ("predictions", "prediction"):
        return (n - 1) * b_pred * batch
    if scheme in ("checkpoints", "checkpoint"):
        return (n - 1) * b_model
    raise ValueError(f"unknown scheme {scheme!r}")


# ----------------------------------------------------------------------------
# model-aware helpers
# ----------------------------------------------------------------------------

def model_bits(cfg: ModelConfig, param_bits: int = 32) -> float:
    return cfg.param_count() * param_bits


def param_bits_of(params) -> float:
    """b_model measured from a LIVE parameter tree (actual dtypes), so
    consumers that move whole replicas bill bytes through one ledger."""
    from repro_torch.tree import tree_leaves

    return float(sum(x.numel() * x.element_size() * 8
                     for x in tree_leaves(params)))


def prediction_bits_classifier(num_classes: int, logit_bits: int = 32) -> float:
    """b_pred for a classifier: one logit vector per sample."""
    return num_classes * logit_bits


def prediction_bits_lm(cfg: ModelConfig, seq_len: int, logit_bits: int = 32,
                       compression: str = "none", topk: int = 64,
                       subsample: int = 0) -> float:
    """b_pred for an LM 'sample' (= one sequence of logits), with the
    beyond-paper compression options accounted for."""
    v = cfg.padded_vocab
    tokens = subsample if (compression == "subsample" and subsample) else seq_len
    if compression == "topk":
        # topk values (logit_bits) + topk int32 indices per token
        per_token = topk * (logit_bits + 32)
    elif compression == "bf16":
        per_token = v * 16
    else:
        per_token = v * logit_bits
    return tokens * per_token


def codist_cost(cfg: ModelConfig, codist: CodistConfig, per_device_batch: int,
                seq_len: Optional[int] = None, param_bits: int = 32,
                logit_bits: int = 32) -> CommCost:
    """Bits/iter/device over cross-group links for a CodistConfig."""
    n, T = codist.n_models, codist.period
    if codist.mode == "checkpoints":
        return codist_checkpoint_bits(model_bits(cfg, param_bits), n, T)
    if seq_len is None:
        b_pred = prediction_bits_classifier(cfg.vocab_size, logit_bits)
    else:
        b_pred = prediction_bits_lm(cfg, seq_len, logit_bits,
                                    codist.compression, codist.topk,
                                    codist.subsample)
    return codist_prediction_bits(b_pred, per_device_batch, n, T)


def paper_resnet50_numbers() -> dict:
    """The exact Section-3 worked example, used as a regression anchor."""
    b_model = 8e8          # "ResNet50 ... will have b_model = 8e8 bits"
    b_pred = 3.2e4         # 1000 classes * 32 bits
    B = 256                # per-model batch size in Fig. 1
    ar = allreduce_bits(b_model)
    out = {"all_reduce": ar.bits_per_iter_per_device}
    for T in (1, 5, 10, 100):
        c = codist_prediction_bits(b_pred, B, n=2, period=T)
        out[f"pred_T{T}"] = c.bits_per_iter_per_device
        out[f"pred_T{T}_ratio"] = c.ratio_vs(ar)
    for T in (625, 1250, 2500, 5000):
        c = codist_checkpoint_bits(b_model, n=2, period=T)
        out[f"ckpt_T{T}"] = c.bits_per_iter_per_device
        out[f"ckpt_T{T}_ratio"] = c.ratio_vs(ar)
    return out
