from repro_torch.checkpoint.bridge import (opt_state_from_jax,  # noqa: F401
                                          params_from_jax, params_to_numpy,
                                          peer_params_from_jax,
                                          peer_params_to_numpy, serving_params)
from repro_torch.checkpoint.io import (load_pytree, read_meta,  # noqa: F401
                                      save_pytree)
