from repro_torch.serve.engine import (default_cache_dtype,  # noqa: F401
                                      resolve_cache_dtype)
