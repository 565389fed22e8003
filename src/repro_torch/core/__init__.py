"""The paper's contribution, ported: federated learning via distributed
mutual learning behind the strategy-composable session layer.

- ``api``         ``Federation`` -- strategy x population session engine
- ``strategies``  what crosses the wire (DML so far)
- ``populations`` who federates (the stacked LM clients so far)
- ``mutual``      Eq. 1/2 losses (categorical, dense)
- ``distributed`` the client-stacked train steps
- ``stacking``    client-axis helpers
"""
