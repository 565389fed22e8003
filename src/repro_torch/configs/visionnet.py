"""VisionNet -- the paper's own CNN case-study model (Fig. 2), the port's
copy of ``repro/configs/visionnet.py``.

3 conv layers (first two followed by 2x2 max-pool), dropout, dense-64,
dropout, sigmoid head; input 100x100x3, binary face-mask classification.
The LM arch registry (``configs.get_config``) does not list it, as in the
JAX package.
"""
import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class VisionNetConfig:
    name: str = "visionnet"
    image_size: int = 100
    channels: int = 3
    conv_features: Tuple[int, ...] = (32, 64, 128)
    kernel_size: int = 3
    dense_features: int = 64
    dropout_rate: float = 0.5
    n_classes: int = 1            # sigmoid binary head (paper §III.B.2)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


CONFIG = VisionNetConfig()


def reduced() -> VisionNetConfig:
    """Fast CPU variant for tests (same topology, 32px)."""
    return CONFIG.replace(image_size=32, conv_features=(8, 16, 32),
                          dense_features=32)
