"""Synthetic data for the port, its own copy of ``repro/data/synthetic.py``
(numpy only; the same seeds give the same bytes).

Images: two-class 'face-mask-like' generator with a controllable
class-separating signal (class 1 adds a bright patch over the lower-center
region) plus per-source appearance shift, so the three FL frameworks can be
compared on learnability AND cross-dataset generalisation (the paper's
dataset-1-train / dataset-2-test protocol).

Tokens: bigram-structured streams (affine next-token rule with noise) with a
per-domain rule so federated clients can be IID or domain-skewed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# images (the paper's case study)

def make_image_dataset(n: int, image_size: int = 100, seed: int = 0,
                       brightness: float = 0.0, noise: float = 0.25,
                       signal: float = 0.45) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced two-class image set.  Returns (images (n,H,W,3), labels (n,))."""
    rng = np.random.default_rng(seed)
    H = W = image_size
    labels = np.arange(n) % 2
    rng.shuffle(labels)
    base = rng.uniform(0.2, 0.6, size=(n, 1, 1, 3)) + brightness
    imgs = np.clip(base + rng.normal(0, noise, size=(n, H, W, 3)), 0, 1)
    # class-1 signal: bright 'mask' patch over lower-center, soft edges
    y0, y1 = int(0.55 * H), int(0.9 * H)
    x0, x1 = int(0.2 * W), int(0.8 * W)
    patch = rng.normal(signal, 0.08, size=(n, y1 - y0, x1 - x0, 3))
    sel = labels.astype(bool)
    region = imgs[sel, y0:y1, x0:x1, :]
    imgs[sel, y0:y1, x0:x1, :] = np.clip(region + patch[sel], 0, 1)
    return imgs.astype(np.float32), labels.astype(np.int32)


def make_paper_datasets(image_size: int = 100, seed: int = 0,
                        n_train: int = 3833, n_test: int = 5988):
    """Dataset 1 (train, GitHub-like) and Dataset 2 (unseen test, Kaggle-like)
    with a deliberate appearance shift between them (paper Table I sizes)."""
    ds1 = make_image_dataset(n_train, image_size, seed=seed,
                             brightness=0.0, noise=0.25)
    ds2 = make_image_dataset(n_test, image_size, seed=seed + 999,
                             brightness=0.08, noise=0.32)
    return ds1, ds2


# ---------------------------------------------------------------------------
# token streams (LLM-scale path)

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


def batched(arrays, batch_size: int, seed: int = 0, drop_last: bool = True):
    """Shuffled mini-batch iterator over aligned numpy arrays."""
    n = arrays[0].shape[0]
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    end = (n // batch_size) * batch_size if drop_last else n
    for i in range(0, end, batch_size):
        idx = order[i: i + batch_size]
        yield tuple(a[idx] for a in arrays)
