"""Synthetic data pipelines."""
from repro_torch.data.synthetic import (MarkovLM, lm_batch_iterator,  # noqa: F401
                                        make_lm_batch)
