"""PyTorch port of the DML federated-learning system, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``repro_torch.<path>`` is the port of ``repro.<path>``) and
imports nothing from it.  The port grows slice by slice: it serves a
stacked K-client population of dense transformers (``repro_torch.serve``)
and trains it by distributed mutual learning (``repro_torch.api``:
``Federation(LMClients(...), DML())``), and runs the paper's VisionNet
case study (``Federation(VisionClients(...), DML() | FedAvg() |
AsyncWeights())``).
"""
