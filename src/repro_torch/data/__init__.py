"""Synthetic data pipelines."""
from repro_torch.data.multiview import (MultiViewTask,  # noqa: F401
                                        multiview_batch)
from repro_torch.data.synthetic import (MarkovLM,  # noqa: F401
                                        classification_batch,
                                        lm_batch_iterator, make_lm_batch)
