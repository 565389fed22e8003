"""The paper's contribution, ported: federated learning via distributed
mutual learning behind the strategy-composable session layer.

- ``api``         ``Federation`` -- strategy x population session engine
- ``strategies``  what crosses the wire (DML, SparseDML, FedAvg,
                  AsyncWeights)
- ``populations`` who federates (the stacked LM clients so far)
- ``mutual``      Eq. 1/2 losses (categorical: dense and top-k)
- ``distributed`` the client-stacked train steps and weight syncs
- ``fedavg``, ``async_fl``  the weight baselines' aggregation helpers
- ``stacking``    client-axis helpers
"""
