"""The paper's own architectures: 3-D ResNet-18 / 26 / 34 (Hara et al.).

Teacher = ResNet-34, TA = ResNet-26, student = ResNet-18, all ending in a
Kinetics-400-way classifier. ``d_model`` holds the stem width (64);
``num_layers`` the total conv depth. Stage block counts live in BLOCKS.
"""
from repro_torch.types import ModelConfig

BLOCKS = {
    "resnet3d-18": (2, 2, 2, 2),
    "resnet3d-22": (2, 2, 3, 3),
    "resnet3d-24": (2, 3, 3, 3),
    "resnet3d-26": (3, 3, 3, 3),
    "resnet3d-28": (3, 3, 4, 3),
    "resnet3d-30": (3, 4, 4, 3),
    "resnet3d-34": (3, 4, 6, 3),
}

KINETICS_CLASSES = 400
CLIP_FRAMES = 8          # "A clip consists of 8 video frames."
CLIP_SIZE = 112          # spatial crop used by Hara et al.


def _mk(name: str) -> ModelConfig:
    depth = 2 + 2 * sum(BLOCKS[name])
    return ModelConfig(
        name=name,
        family="resnet3d",
        num_layers=depth,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=KINETICS_CLASSES,
        num_classes=KINETICS_CLASSES,
        source="arXiv:1708.07632 (Hara et al.), paper §III-A",
    )


RESNET18 = _mk("resnet3d-18")
RESNET26 = _mk("resnet3d-26")
RESNET34 = _mk("resnet3d-34")
