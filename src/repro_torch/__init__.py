"""PyTorch port of the DML federated-learning system, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``repro_torch.<path>`` is the port of ``repro.<path>``) and
imports nothing from it.

Public surface (PEP-562 lazy, so ``import repro_torch`` stays cheap and
imports no session code; everything resolves through
:mod:`repro_torch.api`):

    repro_torch.Federation          the strategy-composable session layer
    repro_torch.DML / SparseDML / FedAvg / AsyncWeights   sharing strategies
    repro_torch.DPDML / TrimmedDML / MedianDML   privacy & robustness variants
    repro_torch.VisionClients / HeteroClients / LMClients   client populations
    repro_torch.checkpoint          npz + JSON checkpoints (the JAX schema)
    repro_torch.interop             params to and from numpy trees

Everything else (kernels, models, launch drivers, the legacy
``core.federated.FederatedTrainer`` and ``core.hetero.HeteroTrainer``) is
importable as submodules: ``repro_torch.core``, ``repro_torch.models``,
``repro_torch.kernels``, ...  Entry points run on the CUDA device unless
they are given ``device="cpu"``.
"""
from __future__ import annotations

__version__ = "0.5.0"

__all__ = [
    "Federation", "History", "RoundLog",
    "Strategy", "Payload", "get_strategy",
    "DML", "SparseDML", "FedAvg", "AsyncWeights",
    "DPDML", "TrimmedDML", "MedianDML",
    "Population", "VisionClients", "HeteroClients", "LMClients",
    "api", "checkpoint", "interop", "__version__",
]

_API_NAMES = {
    "Federation", "History", "RoundLog", "Strategy", "Payload",
    "get_strategy", "DML", "SparseDML", "FedAvg", "AsyncWeights",
    "DPDML", "TrimmedDML", "MedianDML",
    "Population", "VisionClients", "HeteroClients", "LMClients",
}
_SUBMODULES = {"api", "checkpoint", "core", "interop", "sharding"}


def __getattr__(name: str):
    if name in _API_NAMES:
        from repro_torch import api
        return getattr(api, name)
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module(f"repro_torch.{name}")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
