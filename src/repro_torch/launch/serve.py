"""Serving CLI of the port: batched ensemble inference on the card.

  # serve a population checkpoint written by the JAX package, averaging
  # all clients
  PYTHONPATH=src python -m repro_torch.launch.serve --ckpt runs/fed.npz \
      --ensemble average --batch 2 --prompt-len 8 --gen 16

  # no checkpoint: random-init single model (reduced --arch, mamba2-780m
  # unless given, as in the JAX CLI)
  PYTHONPATH=src python -m repro_torch.launch.serve --batch 2 \
      --prompt-len 32 --gen 16

  # continuous batching: more requests than slots, mixed budgets
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --slots 2

  # a random-init reduced qwen3-4b (attention) model on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --device cpu

  # a prefix-token arch: each request carries a random frontend embedding
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llava-next-mistral-7b --requests 3 --device cpu

It runs on the CUDA device unless ``--device cpu`` is given, and fails
without one.  Timing separates WARMUP (the first call, which builds the
kernels when they are not built yet) from STEADY STATE (a repeat), each
ended by a device synchronise; the steady-state number is the serving rate.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.data.synthetic import make_token_stream
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as tfm
from repro_torch.serve import MODES, ServeEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(cfg, params, prompts, gen_len: int, prefix=None, *,
                    impl: str):
    """The per-token Python decode loop (``repro/launch/serve.py:35-52``):
    the token-parity reference the engine and ``make_multistep_decode``
    are held against.  prompts: (B, S0) int tensor on the params' device.
    Returns (B, gen_len) generated ids."""
    B, S0 = prompts.shape
    max_seq = S0 + gen_len + (cfg.prefix_tokens or 0)
    prefill = make_prefill_step(cfg, max_seq=max_seq, impl=impl)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, prompts, prefix)
    out = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    pos = S0 + (cfg.prefix_tokens or 0)
    for t in range(gen_len):
        out.append(tok[:, 0])
        logits, cache = decode(params, tok, cache, pos + t)
        tok = torch.argmax(logits, dim=-1)[:, None]
    return torch.stack(out, dim=1)


def _random_prefix(cfg, batch: int, seed: int):
    """(batch, P, prefix_dim) fp32 N(0, 1) frontend embeddings for a
    prefix-token arch, None otherwise: the JAX CLI's draw."""
    if not cfg.prefix_tokens:
        return None
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (batch, cfg.prefix_tokens, cfg.prefix_dim)
                      ).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None,
                    help="Federation save_state / export_for_serving file "
                         "written by the JAX package; omit to serve a "
                         "random-init --arch model")
    ap.add_argument("--ensemble", choices=MODES, default="average",
                    help="how to serve the K clients of --ckpt")
    ap.add_argument("--client", type=int, default=0,
                    help="client index for --ensemble single")
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2-780m",
                    help="arch for random-init serving (no --ckpt)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="cache arena length (0 = fit batch args exactly)")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--requests", type=int, default=0,
                    help=">0: continuous-batching mode with this many "
                         "mixed-length requests instead of one fixed batch")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    max_seq = args.max_seq or ((args.prompt_len + args.gen) * 2)
    kw = dict(max_seq=max_seq, slots=max(args.slots, args.batch),
              chunk=args.chunk, temperature=args.temperature,
              top_k=args.top_k, seed=args.seed, device=device)
    if args.ckpt:
        eng = ServeEngine.from_checkpoint(
            args.ckpt, mode=args.ensemble, client=args.client, **kw)
        print(f"ckpt={args.ckpt} arch={eng.cfg.name} "
              f"clients={eng.n_checkpoint_clients} mode={eng.mode}")
    else:
        cfg = get_reduced(args.arch)
        params = tfm.init_model(args.seed, cfg, device=device)
        eng = ServeEngine(cfg, params, mode="single", **kw)
        print(f"arch={args.arch} random-init mode=single")
    print(f"device={device} impl={eng.impl}")
    cfg = eng.cfg

    if args.requests:                      # continuous-batching mode
        rng = np.random.default_rng(args.seed)
        budget = max_seq - cfg.prefix_tokens
        for i in range(args.requests):
            s0 = int(rng.integers(2, max(3, min(args.prompt_len,
                                                budget - args.gen) + 1)))
            prompt = rng.integers(0, cfg.vocab_size, (s0,)).astype(np.int32)
            pfx = _random_prefix(cfg, 1, args.seed + i)
            eng.submit(prompt, max_new=min(args.gen, budget - s0),
                       prefix=None if pfx is None else pfx[0])
        t0 = time.perf_counter()
        done = eng.run()
        _sync(device)
        dt = time.perf_counter() - t0
        n_tok = sum(len(v) for v in done.values())
        print(f"served {len(done)} requests over {eng.slots} slots: "
              f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s, "
              f"kernel build included); dispatches={eng.dispatch_counts()}")
        rid = min(done)
        print(f"sample rid={rid}:", done[rid][:16].tolist())
        return 0

    prompts = make_token_stream(args.batch, args.prompt_len, cfg.vocab_size,
                                seed=args.seed)
    prefix = _random_prefix(cfg, args.batch, args.seed)
    n_tok = args.batch * args.gen

    t0 = time.perf_counter()               # warmup: builds the kernels
    gen = eng.generate(prompts, args.gen, prefix=prefix)
    _sync(device)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()               # steady state
    gen = eng.generate(prompts, args.gen, prefix=prefix)
    _sync(device)
    steady = time.perf_counter() - t0
    print(f"generated {gen.shape}: warmup {warm:.2f}s "
          f"({n_tok / warm:.1f} tok/s incl. kernel build), steady "
          f"{steady:.3f}s ({n_tok / steady:.1f} tok/s); dispatches/call="
          f"{len(eng.dispatch_log) // 2}")
    print("sample:", gen[0][:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
