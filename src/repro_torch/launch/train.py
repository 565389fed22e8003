"""Training driver for the port (the JAX package's ``python -m
repro.launch.train``) on reduced configs: single-model pretraining
(``--method single``, the default), a federated session of stacked
same-arch LM clients (``--method dml``) or of one arch PER client
(``--method hetero``) through ``repro_torch.api.Federation``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --steps 20                                 # on the CUDA device
  PYTHONPATH=src python -m repro_torch.launch.train --steps 2 \
      --device cpu --save runs/single            # plain PyTorch on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --method dml \
      --clients 3 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
      --method dml --device cpu                  # reduced mamba2 (SSD) clients
  PYTHONPATH=src python -m repro_torch.launch.train --method dml \
      --clients 3 --strategy sparse-dml --sparse-k 64 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --method dml \
      --clients 3 --strategy fedavg --steps 4 --device cpu   # or async
  PYTHONPATH=src python -m repro_torch.launch.train --method hetero \
      --archs qwen3-4b,mamba2-780m,dbrx-132b --rounds 3 --participation 2
  PYTHONPATH=src python -m repro_torch.launch.train --method hetero \
      --archs qwen3-4b,qwen3-4b --strategy fedavg --rounds 3 --device cpu

``--strategy`` picks what crosses the wire: dml, sparse-dml, fedavg,
async, or the privacy and robustness strategies of the prediction-sharing
populations: dp-dml clips and Gaussian-noises every shared payload
(``--dp-epsilon`` calibrates the noise to a target budget over the
schedule's releases), trimmed-/median-dml swap the Eq.-2 mean for a robust
consensus, and ``--byzantine`` injects poisoned clients into a hetero
fleet:

  PYTHONPATH=src python -m repro_torch.launch.train --method hetero \
      --archs qwen3-4b,mamba2-780m --strategy dp-dml --dp-epsilon 4.0
  PYTHONPATH=src python -m repro_torch.launch.train --method hetero \
      --archs qwen3-4b,mamba2-780m,qwen3-4b --strategy median-dml \
      --byzantine 2=sign-flip --rounds 3

The stacked LM population (``--method dml``) refuses the three, as the
JAX one does.  The full-width runs are ``chip_smoke.py``'s.

Device-sharded DML (``--mesh clients=N``, ``--method dml``): each entry of
the client mesh owns whole clients, and the only cross-entry tensor is the
gathered public logits (``core.distributed.make_sharded_dml_step``).  The
mesh is built on ``--device``: N cards, or N entries of the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --method dml \
      --clients 4 --steps 8 --mesh clients=2 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.core.strategies import get_strategy
from repro_torch.kernels import ops


def _make_strategy(args):
    """The strategy of ``--strategy`` from one knob namespace (the JAX
    CLI's ``_make_strategy``); ``get_strategy`` drops the knobs it does not
    take.  ``--dp-epsilon`` calibrates dp-dml's noise multiplier over the
    schedule's releases (rounds for hetero, steps otherwise)."""
    knobs = dict(kl_weight=args.kl_weight, k=args.sparse_k, trim=args.trim,
                 dp_clip=args.dp_clip, dp_delta=args.dp_delta,
                 dp_seed=args.seed)
    if args.strategy == "dp-dml":
        sigma = args.dp_noise
        if args.dp_epsilon:
            from repro_torch.privacy import calibrate_noise
            releases = args.rounds if args.method == "hetero" else args.steps
            sigma = calibrate_noise(args.dp_epsilon, args.dp_delta, releases)
            print(f"calibrated dp noise multiplier: sigma={sigma:.4f} for "
                  f"(eps={args.dp_epsilon}, delta={args.dp_delta}) over "
                  f"{releases} releases")
        knobs["dp_noise_multiplier"] = sigma
    return get_strategy(args.strategy, **knobs)


def _parse_byzantine(spec: str) -> dict:
    """``"2=collude,0=sign-flip"`` -> {2: "collude", 0: "sign-flip"}."""
    out = {}
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        idx, _, mode = item.partition("=")
        if not mode:
            raise SystemExit(
                f"--byzantine entries are IDX=MODE, got {item!r}")
        out[int(idx)] = mode
    return out


def _print_history(h) -> None:
    for rl in h.rounds:
        print(f"round {rl.round:3d} participants={rl.participants} "
              f"loss={['%.3f' % x for x in rl.client_loss]} "
              f"kld={['%.4f' % x for x in rl.kl_loss]} "
              f"comm_bytes={rl.comm_bytes}", flush=True)
    print(f"total_comm_bytes={h.total_comm_bytes}")


def _run_hetero(args) -> int:
    """Heterogeneous-client federation (one arch per client)."""
    from repro_torch.api import Federation, HeteroClients, make_lm_pool

    archs = tuple(a.strip() for a in args.archs.split(",") if a.strip())
    vocab = get_reduced(archs[0]).vocab_size
    n_folds = (1 + len(archs)) * args.rounds + 1
    pool, labels = make_lm_pool(n_folds * max(2 * args.batch, 8),
                                args.seq, vocab, seed=args.seed)
    t0 = time.time()
    strategy = _make_strategy(args)
    population = HeteroClients(
        archs, pool, labels, rounds=args.rounds, batch_size=args.batch,
        public_batch=max(1, args.batch // 2), lr=args.lr, seed=args.seed,
        kernel_impl=args.kernel_impl,
        byzantine=_parse_byzantine(args.byzantine), device=args.device)
    fed = Federation(population, strategy, participation=args.participation)
    print(f"federating [{args.strategy}]:", ", ".join(
        f"{a} ({population._models[a].family})" for a in archs))
    print(f"on {population.device}, kernels {population.impl}")
    if args.resume:
        fed.restore_state(args.resume)
        print(f"resumed from {args.resume} at round {fed.round}")
    h = fed.run(until=args.until)
    _print_history(h)
    if hasattr(fed.strategy, "epsilon"):
        print(f"privacy spent: epsilon={fed.strategy.epsilon():.3f} at "
              f"delta={fed.strategy.dp_delta}")
    fed.evaluate()
    print(f"held-out eval loss per client: "
          f"{['%.3f' % x for x in h.client_eval_loss]}")
    print(f"done in {time.time() - t0:.1f}s")
    if args.save:
        fed.save_state(args.save)
        print(f"saved federated state to {args.save}")
    return 0


def _run_single(args, cfg) -> int:
    """Single-model pretraining (``repro/launch/train.py:232-283``): the
    batches are ``make_token_stream`` of domain 0 seeded by the step, and
    a prefix-token arch's embeddings N(0, 1) seeded by the step."""
    from repro_torch import checkpoint
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, adamw_init

    device = ops.resolve_device(args.device)
    impl = ops.resolve_impl(args.kernel_impl, device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup=5, total_steps=args.steps)

    def batch_for(domain: int, step: int, batch: int):
        toks = make_token_stream(batch, args.seq + 1, cfg.vocab_size,
                                 seed=1000 * step + args.seed, domain=domain)
        out = [torch.as_tensor(toks[:, :args.seq], dtype=torch.long,
                               device=device)]
        if cfg.prefix_tokens:
            rng = np.random.default_rng(step)
            out.append(torch.as_tensor(rng.normal(
                0, 1, (batch, cfg.prefix_tokens, cfg.prefix_dim))
                .astype(np.float32), device=device))
        return out

    t0 = time.time()
    params = tfm.init_model(args.seed, cfg, device=device)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, opt_cfg, impl=impl)
    print(f"model: {cfg.name} on {device}, kernels {impl}")
    for i in range(args.steps):
        params, opt, m = step_fn(params, opt, *batch_for(0, i, args.batch))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} ce={float(m['ce']):.4f} "
                  f"gnorm={float(m['grad_norm']):.2f}", flush=True)

    print(f"done in {time.time() - t0:.1f}s")
    if args.save:
        checkpoint.save(args.save, params,
                        {"arch": args.arch, "method": args.method,
                         "steps": args.steps})
        print(f"saved checkpoint to {args.save}")
    return 0


def _run_federated_lm(args, cfg) -> int:
    """Stacked same-arch LM clients."""
    from repro_torch.api import Federation, LMClients

    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_client_mesh, parse_mesh_spec
        axes = parse_mesh_spec(args.mesh)
        if set(axes) != {"clients"}:
            raise SystemExit(f"--mesh supports clients=N, got {args.mesh}")
        mesh = make_client_mesh(axes["clients"], device=args.device)
        print(f"sharding {args.clients} clients over {axes['clients']} "
              "devices (all-gather of public logits is the only collective)")
    t0 = time.time()
    strategy = _make_strategy(args)
    population = LMClients(cfg, n_clients=args.clients, rounds=args.steps,
                           batch=args.batch, seq=args.seq, lr=args.lr,
                           seed=args.seed, mesh=mesh, device=args.device,
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
    ap.add_argument("--method", choices=["single", "dml", "hetero"],
                    default="single",
                    help="single model, stacked same-arch clients (dml), "
                         "or one arch per client (hetero)")
    ap.add_argument("--strategy", default="dml",
                    choices=["dml", "sparse-dml", "fedavg", "async",
                             "dp-dml", "trimmed-dml", "median-dml"],
                    help="what crosses the wire each round "
                         "(federated methods only)")
    ap.add_argument("--sparse-k", type=int, default=64,
                    help="top-k kept per position for --strategy sparse-dml")
    ap.add_argument("--dp-noise", type=float, default=1.0,
                    help="Gaussian noise multiplier sigma for dp-dml "
                         "(std = clip * sigma per shared payload)")
    ap.add_argument("--dp-clip", type=float, default=1.0,
                    help="L2 clip bound on each dp-dml payload")
    ap.add_argument("--dp-delta", type=float, default=1e-5,
                    help="delta of the reported (eps, delta) guarantee")
    ap.add_argument("--dp-epsilon", type=float, default=0.0,
                    help="target epsilon: calibrate --dp-noise to spend "
                         "at most this over the whole schedule "
                         "(overrides --dp-noise)")
    ap.add_argument("--byzantine", default="", metavar="IDX=MODE,...",
                    help="poisoned clients for --method hetero, e.g. "
                         "'2=collude,0=sign-flip' (modes: label-flip, "
                         "sign-flip, collude)")
    ap.add_argument("--trim", type=int, default=1,
                    help="values trimmed per side by --strategy "
                         "trimmed-dml")
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
    ap.add_argument("--kernel-impl", default="auto",
                    choices=["auto", "ref", "cuda"],
                    help="kernel implementation: 'auto' resolves per device "
                         "(cuda on a CUDA device, ref on the CPU; "
                         "REPRO_KERNEL_IMPL overrides)")
    ap.add_argument("--save", default=None, help="checkpoint path")
    ap.add_argument("--mesh", default=None, metavar="clients=N",
                    help="shard the DML client axis over a 'clients' mesh "
                         "of N entries on --device (--method dml)")
    ap.add_argument("--until", type=int, default=0,
                    help="stop after this round/step (0 = run the full "
                         "schedule); with --save this checkpoints "
                         "mid-schedule so a later --resume run (SAME "
                         "schedule) continues it")
    ap.add_argument("--participation", type=int, default=0,
                    help="clients sampled per round, 0 = all")
    ap.add_argument("--resume", default=None,
                    help="restore a --save checkpoint and continue "
                         "(federated methods)")
    # hetero-only knobs: one arch PER client; round-based schedule
    ap.add_argument("--archs", default="qwen3-4b,mamba2-780m,dbrx-132b",
                    help="comma-separated arch id per client (hetero)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="federated rounds (hetero)")
    args = ap.parse_args(argv)

    if args.method == "hetero":
        return _run_hetero(args)
    cfg = get_reduced(args.arch)
    if args.method == "dml":
        return _run_federated_lm(args, cfg)
    return _run_single(args, cfg)


if __name__ == "__main__":
    raise SystemExit(main())
