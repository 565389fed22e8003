"""The port's public session API, one import site, as ``repro.api``:

    from repro_torch.api import Federation, LMClients, VisionClients, DML

    session = Federation(LMClients(cfg, n_clients=3), DML())
    session.run()
    Federation(VisionClients(vn_cfg, images, labels), DML()).run()
    pool, labels = make_lm_pool(n, seq, vocab)
    Federation(HeteroClients(("qwen3-4b", "mamba2-780m"), pool, labels),
               SparseDML(k=16)).run()
"""
from repro_torch.core.api import Federation, History, RoundLog
from repro_torch.core.populations import (HeteroClients, LMClients,
                                           Population, VisionClients,
                                           comm_bytes_per_round,
                                           make_lm_pool)
from repro_torch.core.strategies import (DML, DPDML, STRATEGIES,
                                         AsyncWeights, FedAvg, MedianDML,
                                         Payload, SparseDML, Strategy,
                                         TrimmedDML, get_strategy)

__all__ = ["Federation", "History", "RoundLog", "Strategy", "Payload",
           "STRATEGIES", "get_strategy", "DML", "SparseDML", "DPDML",
           "TrimmedDML", "MedianDML", "FedAvg", "AsyncWeights",
           "Population", "LMClients", "VisionClients", "HeteroClients",
           "make_lm_pool", "comm_bytes_per_round"]
