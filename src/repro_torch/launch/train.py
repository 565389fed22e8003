"""Training driver for the port: a federated session of stacked same-arch
LM clients through ``repro_torch.api.Federation`` (the JAX package's
``python -m repro.launch.train --method dml``), on the reduced config of
``--arch``.

  PYTHONPATH=src python -m repro_torch.launch.train --method dml \
      --clients 3 --steps 8                      # on the CUDA device
  PYTHONPATH=src python -m repro_torch.launch.train --method dml \
      --clients 3 --steps 2 --device cpu         # plain PyTorch on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
      --method dml --device cpu                  # reduced mamba2 (SSD) clients
  PYTHONPATH=src python -m repro_torch.launch.train --method dml \
      --clients 3 --strategy sparse-dml --sparse-k 64 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --method dml \
      --clients 3 --strategy fedavg --steps 4 --device cpu   # or async

``--strategy`` picks what crosses the wire: dml, sparse-dml, fedavg or
async.  The JAX CLI's privacy and robust strategies, the single-model and
heterogeneous methods and ``--mesh`` are not ported; those strategies
raise, naming the slice of the port they come with.  The full-width run is
``chip_smoke.py``'s.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.core.strategies import NOT_PORTED, get_strategy


def _make_strategy(args):
    """The strategy of ``--strategy`` from one knob namespace (the JAX
    CLI's ``_make_strategy``); ``get_strategy`` drops the knobs it does not
    take."""
    return get_strategy(args.strategy, kl_weight=args.kl_weight,
                        k=args.sparse_k)


def _run_federated_lm(args, cfg) -> int:
    """Stacked same-arch LM clients."""
    from repro_torch.api import Federation, LMClients

    t0 = time.time()
    strategy = _make_strategy(args)
    population = LMClients(cfg, n_clients=args.clients, rounds=args.steps,
                           batch=args.batch, seq=args.seq, lr=args.lr,
                           seed=args.seed, device=args.device,
                           kernel_impl=args.kernel_impl)
    fed = Federation(population, strategy, participation=args.participation)
    print(f"model: {cfg.name} x {args.clients} clients [{args.strategy} "
          f"strategy] on {population.device}, kernels {population.impl}")
    if args.resume:
        fed.restore_state(args.resume)
        print(f"resumed from {args.resume} at step {fed.round}")
    h = fed.run(until=args.until)
    for rl in h.rounds:
        if rl.round % 5 == 0 or rl.round == args.steps - 1:
            pl_ = np.asarray(rl.client_loss)
            kl = np.asarray(rl.kl_loss)
            print(f"step {rl.round:4d} loss={pl_.mean():.4f} "
                  f"kld_avg={kl.mean():.5f} spread={pl_.std():.4f} "
                  f"comm_bytes={rl.comm_bytes}", flush=True)
    print(f"total_comm_bytes={h.total_comm_bytes}")
    print(f"done in {time.time() - t0:.1f}s")
    if args.save:
        fed.save_state(args.save)
        print(f"saved federated state to {args.save}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--method", choices=["dml"], default="dml",
                    help="stacked same-arch clients (the single-model and "
                         "heterogeneous methods are not ported yet)")
    ap.add_argument("--strategy", default="dml",
                    choices=["dml", "sparse-dml", "fedavg", "async",
                             *NOT_PORTED],
                    help="what crosses the wire each round (dml, "
                         "sparse-dml, fedavg and async are ported)")
    ap.add_argument("--sparse-k", type=int, default=64,
                    help="top-k kept per position for --strategy sparse-dml")
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--kl-weight", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain versions on the CPU)")
    ap.add_argument("--kernel-impl", default=None, choices=["ref", "cuda"],
                    help="kernel implementation (default: cuda on a CUDA "
                         "device, ref on the CPU)")
    ap.add_argument("--save", default=None, help="checkpoint path")
    ap.add_argument("--until", type=int, default=0,
                    help="stop after this step (0 = run the full schedule); "
                         "with --save this checkpoints mid-schedule so a "
                         "later --resume run continues it")
    ap.add_argument("--participation", type=int, default=0,
                    help="clients sampled per round, 0 = all")
    ap.add_argument("--resume", default=None,
                    help="restore a --save checkpoint and continue")
    args = ap.parse_args(argv)
    return _run_federated_lm(args, get_reduced(args.arch))


if __name__ == "__main__":
    raise SystemExit(main())
