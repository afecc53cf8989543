from repro_torch.serve.engine import (Engine, GenerationResult,  # noqa: F401
                                      default_cache_dtype, resolve_cache_dtype)
