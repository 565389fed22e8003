"""One NVIDIA H100 SXM's published dense peaks at its 700 W limit
(NVIDIA's data sheet), a frozen copy of ``repro_torch.launch.mesh.H100``."""
from __future__ import annotations

BF16_FLOPS = 989e12     # tensor cores, bf16 and fp16, dense
FP32_FLOPS = 67e12      # fp32 outside the tensor cores
HBM_BYTES = 3.35e12     # HBM3 bytes/s


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations
    at ``peak_flops`` and the bytes at the HBM rate."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
