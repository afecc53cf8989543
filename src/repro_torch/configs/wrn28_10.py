"""wrn28x10 [paper's own multi-view workload] — Wide-ResNet 28x10 on CIFAR-10 as in
Section 5.1 (frozen first-bottleneck channel-split experiment, after Allen-Zhu & Li).
"""
from repro_torch.models.conv import ConvConfig

CONFIG = ConvConfig(
    name="wrn28x10",
    kind="wideresnet",
    depths=(4, 4, 4),          # (28-4)/6 = 4 blocks per group
    widths=(160, 320, 640),
    bottleneck=False,
    num_classes=10,
    image_size=32,
    source="WRN-28-10 [arXiv:1605.07146]; multi-view setup [arXiv:2012.09816]",
)


def reduced():
    return ConvConfig(
        name="wrn28x10-reduced",
        kind="wideresnet",
        depths=(1, 1),
        widths=(32, 64),
        bottleneck=False,
        num_classes=10,
        image_size=32,
        source=CONFIG.source,
    )
