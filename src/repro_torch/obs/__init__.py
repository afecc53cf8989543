from repro_torch.obs.metrics import Histogram  # noqa: F401
