"""Synthetic token streams, the port's own copy of
``repro/data/synthetic.py::make_token_stream`` (numpy only)."""
from __future__ import annotations

import numpy as np


def make_token_stream(n_seqs: int, seq_len: int, vocab: int, seed: int = 0,
                      domain: int = 0, noise: float = 0.15) -> np.ndarray:
    """Learnable bigram streams: next = (a*t + b) % vocab with prob 1-noise."""
    rng = np.random.default_rng(seed + 7919 * domain)
    a = 31 + 2 * domain
    b = 7 + domain
    toks = np.empty((n_seqs, seq_len), np.int32)
    toks[:, 0] = rng.integers(0, vocab, n_seqs)
    for t in range(1, seq_len):
        nxt = (a * toks[:, t - 1] + b) % vocab
        rand = rng.integers(0, vocab, n_seqs)
        use_rand = rng.random(n_seqs) < noise
        toks[:, t] = np.where(use_rand, rand, nxt)
    return toks
