"""The port's public session API, one import site, as ``repro.api``:

    from repro_torch.api import Federation, LMClients, VisionClients, DML

    session = Federation(LMClients(cfg, n_clients=3), DML())
    session.run()
    Federation(VisionClients(vn_cfg, images, labels), DML()).run()
"""
from repro_torch.core.api import Federation, History, RoundLog
from repro_torch.core.populations import (LMClients, Population,
                                           VisionClients)
from repro_torch.core.strategies import (DML, STRATEGIES, AsyncWeights,
                                         FedAvg, Payload, SparseDML,
                                         Strategy, get_strategy)

__all__ = ["Federation", "History", "RoundLog", "Strategy", "Payload",
           "STRATEGIES", "get_strategy", "DML", "SparseDML", "FedAvg",
           "AsyncWeights", "Population", "LMClients", "VisionClients"]
