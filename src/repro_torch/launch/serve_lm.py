"""Batched serving on the port: request waves of prefill + decode against
the ring-buffer KV / SSM cache.  The analogue of the JAX package's
``examples/serve_lm.py``:

  PYTHONPATH=src python -m repro_torch.launch.serve_lm \
      [--arch mamba2-780m] [--device cpu]

Each wave is ``greedy_generate`` over a batch of prompts of a reduced
arch from seeded random weights (prefix-token archs with their prefix
switched off, as in the example).  On the card the prefill runs the flash
forward, or for mamba2 the SSD forward.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.data.synthetic import make_token_stream
from repro_torch.kernels import ops
from repro_torch.launch.serve import _sync, greedy_generate
from repro_torch.models import transformer as tfm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2-780m")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    device = ops.resolve_device(args.device)
    impl = ops.resolve_impl(None, device)
    cfg = get_reduced(args.arch).replace(prefix_tokens=0, prefix_dim=0)
    params = tfm.init_model(0, cfg, device=device)
    print(f"serving {args.arch} (reduced), batch={args.batch}, "
          f"{args.requests} request waves on {device}, kernels {impl}")

    total_tok, t0 = 0, time.perf_counter()
    for r in range(args.requests):
        prompts = torch.as_tensor(make_token_stream(
            args.batch, args.prompt_len, cfg.vocab_size, seed=r),
            device=device)
        gen = greedy_generate(cfg, params, prompts, args.gen, impl=impl)
        total_tok += gen.numel()
        print(f"  wave {r}: prompts{tuple(prompts.shape)} -> "
              f"generated{tuple(gen.shape)}  first={gen[0, :8].tolist()}")
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"served {total_tok} tokens in {dt:.1f}s "
          f"({total_tok / dt:.1f} tok/s, kernel build included)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
