"""The synthetic token streams, a frozen copy of
``repro_torch.data.synthetic.make_token_stream`` (itself the JAX package's
``repro/data/synthetic.py``): the same seeds give the same tokens.  The
reference draws every batch it checks from here, never from the port."""
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


def private_batch(r: int, seed: int, n_clients: int, batch: int, seq: int,
                  vocab: int) -> np.ndarray:
    """(K, B, S) round ``r``'s private tokens, client k on bigram domain k
    (the seeds ``repro_torch.core.populations.lm.LMClients`` uses)."""
    return np.stack([make_token_stream(batch, seq + 1, vocab,
                                       seed=1000 * r + seed,
                                       domain=d)[:, :seq]
                     for d in range(n_clients)])


def public_batch(r: int, seed: int, n_clients: int, batch: int, seq: int,
                 vocab: int) -> np.ndarray:
    """(B_pub, S) round ``r``'s public tokens, B_pub = max(1, B // 2), on
    the unseen domain K."""
    return make_token_stream(max(1, batch // 2), seq + 1, vocab,
                             seed=1000 * (10_000 + r) + seed,
                             domain=n_clients)[:, :seq]
