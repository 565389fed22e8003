"""Quickstart on the port: federated mutual learning across 3 LLM clients
through the session API.  The analogue of the JAX package's
``examples/quickstart.py``:

    Federation(LMClients(cfg, n_clients=3), DML(kl_weight=2.0))

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--rounds 15] \
      [--device cpu]

One ``Federation`` composes a sharing strategy (``DML``: clients share
only public-batch logits and descend Eq. 1 -- never weights) with a client
population (``LMClients``: K reduced-LLM clients stacked on the leading
axis of every param and moment, one fused update a round).  Swap the
strategy -- ``SparseDML(k=64)``, ``FedAvg()``, ``AsyncWeights()`` -- and
nothing else changes; the session's comm ledger shows what each choice
costs on the wire.  On the card the round runs the flash-attention
forward and backward and the Eq.-2 square KL forward and backward.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import DML, Federation, LMClients
from repro_torch.configs import get_reduced
from repro_torch.core.fedavg import comm_bytes_per_round
from repro_torch.core.mutual import sparse_share_bytes

K = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=15)     # the example's 15
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    steps = args.rounds

    cfg = get_reduced("qwen3-4b")
    print(f"model: {cfg.name} (reduced: {cfg.n_layers}L d={cfg.d_model}) "
          f"x {K} clients")

    # each client has its own bigram domain (non-IID); the public batch is
    # fresh every round ("dynamically changing test dataset", paper SIII.A)
    session = Federation(
        LMClients(cfg, n_clients=K, rounds=steps, batch=2, seq=48, lr=3e-3,
                  device=args.device),
        DML(kl_weight=2.0))
    pop = session.population
    print(f"on {pop.device}, kernels {pop.impl}")
    history = session.run()

    for rl in history.rounds:
        if rl.round % 3 == 0 or rl.round == steps - 1:
            print(f"step {rl.round:3d}  "
                  f"private={np.mean(rl.client_loss):.4f}  "
                  f"public_ce={np.mean(rl.public_ce):.4f}  "
                  f"kld_avg={np.mean(rl.kl_loss):.5f}")

    # the bandwidth story (the paper's central claim), at this exact setup:
    # the same session under weight sharing vs dense vs sparse prediction
    # sharing
    logit_bytes = history.rounds[-1].comm_bytes
    weight_bytes = comm_bytes_per_round(pop.params_per_client, K)
    positions = max(1, pop.batch // 2) * pop.seq   # the public batch
    sparse_bytes = sparse_share_bytes(K, positions, 64)
    print(f"\nper-round sharing: DML={logit_bytes / 1e6:.2f} MB "
          f"vs FedAvg={weight_bytes / 1e6:.2f} MB "
          f"({weight_bytes / logit_bytes:.0f}x less traffic; "
          f"sparse top-64: {sparse_bytes / 1e3:.1f} kB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
