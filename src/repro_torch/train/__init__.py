"""Training: states, the strategy-driven step engine and the host loop."""
from repro_torch.train.engine import (  # noqa: F401
    AllReduce, AsyncPrediction, CheckpointExchange, ExchangeStrategy,
    PipelinedPredictions, PredictionExchange, ShardMapCompressed, StepBundle,
    build_train_step, make_codist_eval_step, make_eval_step, refresh_stale,
    resolve_strategy)
from repro_torch.train.loop import (History, stack_batches,  # noqa: F401
                                    train, train_allreduce, train_codist)
from repro_torch.train.state import (CodistState, TrainState,  # noqa: F401
                                     init_codist_state, init_peer_state,
                                     init_train_state)
