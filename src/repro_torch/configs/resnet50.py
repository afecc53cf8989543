"""resnet50 [paper's own vision workload] — He et al. [arXiv:1512.03385], trained on
ImageNet-1k per Goyal et al. [arXiv:1706.02677] (the paper's Section 4.1 baseline).

Used for the paper-faithful communication model numbers (b_model = 8e8 bits,
b_pred = 3.2e4 bits at 1000 classes) and reduced-scale codistillation runs.
Conv configs use a separate dataclass (see repro/models/conv.py).
"""
from repro_torch.models.conv import ConvConfig

CONFIG = ConvConfig(
    name="resnet50",
    kind="resnet",
    depths=(3, 4, 6, 3),
    widths=(256, 512, 1024, 2048),
    bottleneck=True,
    num_classes=1000,
    image_size=224,
    source="ResNet-50 [arXiv:1512.03385] / Goyal et al. [arXiv:1706.02677]",
)


def reduced():
    return ConvConfig(
        name="resnet50-reduced",
        kind="resnet",
        depths=(1, 1),
        widths=(32, 64),
        bottleneck=True,
        num_classes=10,
        image_size=32,
        source=CONFIG.source,
    )
