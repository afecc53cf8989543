from repro_torch.checkpoint.bridge import (params_from_jax,  # noqa: F401
                                          params_to_numpy, serving_params)
