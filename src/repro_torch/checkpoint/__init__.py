from repro_torch.checkpoint.bridge import (opt_state_from_jax,  # noqa: F401
                                          params_from_jax, params_to_numpy,
                                          peer_params_from_jax,
                                          peer_params_to_numpy, serving_params)
from repro_torch.checkpoint.io import (has_snapshot, load_pytree,  # noqa: F401
                                      load_snapshot, load_snapshot_params,
                                      read_meta, save_pytree, save_snapshot,
                                      snapshot_meta, snapshot_path)
