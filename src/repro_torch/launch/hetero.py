"""Federated mutual learning across HETEROGENEOUS architectures on the
port -- a dense transformer, an attention-free SSM and a fine-grained MoE
learn from each other through the session API.  The analogue of the JAX
package's ``examples/dml_heterogeneous.py``:

    Federation(HeteroClients(archs, pool, labels), DML() | SparseDML(k))

  PYTHONPATH=src python -m repro_torch.launch.hetero [--rounds 4] \
      [--device cpu]

Weight averaging is impossible here (the client trees do not match); the
``Federation`` rejects ``FedAvg()`` on this population at construction,
while prediction sharing (``DML``) -- and its bandwidth-constrained
``SparseDML(k)`` variant -- just works: only the (M, N_pub, V) public-set
logits (or their top-k compression) ever cross a client boundary.  The
clients are the archs' reduced configs, as in the example; the full-width
fleet runs on the card in ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse

from repro_torch.api import (DML, Federation, HeteroClients, SparseDML,
                             make_lm_pool)

ARCHS = ("qwen3-4b", "mamba2-780m", "dbrx-132b")   # dense / ssm / moe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    rounds = args.rounds

    pool, labels = make_lm_pool(((1 + len(ARCHS)) * rounds + 1) * 8,
                                seq_len=48, vocab=512, seed=0)
    kw = dict(rounds=rounds, local_epochs=1, batch_size=4, public_batch=4,
              lr=3e-3, seed=0, device=args.device)
    population = HeteroClients(ARCHS, pool, labels, **kw)
    session = Federation(population, DML(kl_weight=2.0))

    print("federating:", ", ".join(
        f"{a} ({population._models[a].family})" for a in ARCHS))
    print(f"on {population.device}, kernels {population.impl}")
    history = session.run()
    for rl in history.rounds:
        print(f"round {rl.round:3d}  "
              f"local={['%.3f' % x for x in rl.client_loss]}  cross-arch "
              f"kld={['%.4f' % x for x in rl.kl_loss]}  "
              f"comm_bytes={rl.comm_bytes}")

    session.evaluate()
    print(f"\nheld-out eval loss per client: "
          f"{['%.3f' % x for x in history.client_eval_loss]}")
    print(f"total logits traffic: {history.total_comm_bytes} bytes (vs "
          f"per-round weight averaging: undefined -- client trees have "
          f"{[f'{n:,}' for n in population.n_params]} params and different "
          f"structures)")

    # the same fleet under sparse top-k sharing: V/(2k) fewer bytes
    sparse = Federation(HeteroClients(ARCHS, pool, labels, **kw),
                        SparseDML(k=16, kl_weight=2.0))
    hs = sparse.run()
    print(f"\nsparse top-16 sharing: {hs.total_comm_bytes} bytes "
          f"({history.total_comm_bytes / hs.total_comm_bytes:.0f}x below "
          "dense DML; weight averaging remains undefined)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
