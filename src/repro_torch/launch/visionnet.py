"""The paper's case study, end to end, on the port: VisionNet face-mask
classification under Algorithm 1, all three frameworks, full fold
discipline, evaluation on the unseen second dataset (paper Table II).
The analogue of the JAX package's ``examples/federated_visionnet.py``:

    Federation(VisionClients(...), DML() | FedAvg() | AsyncWeights())

  PYTHONPATH=src python -m repro_torch.launch.visionnet [--rounds 12] \
      [--clients 5] [--fast] [--device cpu]

As in the example, the model is the reduced 32px VisionNet; ``--fast``
cuts the rounds, clients and datasets to CI size.  The full 100px
configuration runs on the card in ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.api import (DML, AsyncWeights, FedAvg, Federation,
                             VisionClients)
from repro_torch.configs.visionnet import reduced
from repro_torch.data.synthetic import make_paper_datasets

NAMES = {"fedavg": "Vanilla FL", "async": "Async Weight FL",
         "dml": "Mutual Learning FL (ours)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)        # paper: 12
    ap.add_argument("--clients", type=int, default=5)        # paper: 5
    ap.add_argument("--fast", action="store_true",
                    help="fewer rounds, clients and images (CI-sized)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    vn = reduced()
    rounds = 3 if args.fast else args.rounds
    clients = 3 if args.fast else args.clients
    n_train, n_test = (900, 300) if args.fast else (3833, 5988)  # Table I
    (tr_x, tr_y), (te_x, te_y) = make_paper_datasets(
        image_size=vn.image_size, n_train=n_train, n_test=n_test)
    print(f"dataset1 (train): {len(tr_x)}  dataset2 (unseen test): "
          f"{len(te_x)}")

    strategies = {
        "fedavg": FedAvg(),
        "async": AsyncWeights(delta=3, min_round=1 if args.fast else 5),
        "dml": DML(kl_weight=1.0, mutual_epochs=1),
    }
    results = {}
    for name, strategy in strategies.items():
        t0 = time.time()
        fed = Federation(
            VisionClients(vn, tr_x, tr_y, n_clients=clients, rounds=rounds,
                          local_epochs=3, batch_size=16, lr=0.05,
                          device=args.device),
            strategy)
        h = fed.run()
        n_calls = sum(1 for r, _ in fed.dispatch_log if 0 <= r < rounds)
        h = fed.evaluate(split=(te_x, te_y))
        results[name] = h
        accs = " ".join(f"{100 * a:5.2f}" for a in h.client_test_acc)
        print(f"\n{name:8s} client accuracies: {accs}")
        print(f"{'':8s} round engine: {n_calls / rounds:.1f} phase calls/"
              f"round on {fed.population.device} "
              f"({time.time() - t0:.1f} s with eval)")
        spread = max(h.client_test_acc) - min(h.client_test_acc)
        print(f"{'':8s} spread={100 * spread:.2f}pp "
              f"comm={h.total_comm_bytes / 1e6:.3f} MB "
              f"global_acc={100 * h.global_test_acc:.2f}")

    print("\n--- paper Table II analogue (unseen dataset) ---")
    print(f"{'framework':28s}"
          + "".join(f"client{i:d}  " for i in range(clients)))
    for m, h in results.items():
        row = "".join(f"{100 * a:7.2f}  " for a in h.client_test_acc)
        print(f"{NAMES[m]:28s}{row}")
    ratio = results["fedavg"].total_comm_bytes / max(
        results["dml"].total_comm_bytes, 1)
    print(f"\nDML uses {ratio:.0f}x less communication than vanilla FL.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
