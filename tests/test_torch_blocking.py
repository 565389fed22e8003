"""The client and sender blocking of the port's KL wrappers, on the CPU.

One launch of the pair-KL kernel takes at most ``kl_mutual.MAX_CLIENTS``
clients a side, and one launch of the sparse-KL kernel at most
``sparse_kl.MAX_SENDERS`` senders and ``sparse_kl.MAX_ENTRIES`` entries, so
the wrappers cut more clients or senders into blocks (``blocked_pair``,
``blocked_senders``).  Here the blocking helpers are driven by the plain
versions, block by block, and held against the unblocked plain versions
and the JAX package's oracles on the same numpy inputs, forward and
gradient.  Tolerances (fp32): 1e-5 absolute and relative between the port's
blocked and unblocked sums (the same terms added in another order), 3e-5
against JAX (``tests/test_kernels_sparsekl.py``'s pin).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import kl_mutual, ref, sparse_kl


def _pair_inputs(Kl, Kg, B=3, V=97, seed=0):
    rng = np.random.default_rng(seed)
    live = (2 * rng.standard_normal((Kl, B, V))).astype(np.float32)
    fixed = (2 * rng.standard_normal((Kg, B, V))).astype(np.float32)
    w = rng.random((Kl, Kg)).astype(np.float32)
    w[:, -1] = 0.0                       # an absent client, as masks make
    gbar = rng.standard_normal((Kl, B)).astype(np.float32)
    return live, fixed, w, gbar


@pytest.mark.parametrize("Kl,Kg", [(9, 9), (16, 16), (9, 16), (16, 3)])
def test_blocked_pair_matches_unblocked(Kl, Kg):
    """Eq. 2 at more than MAX_CLIENTS clients a side, blocked and driven by
    ``ref.mutual_kl_pair`` per block: the loss and both sides' gradients
    against the unblocked plain version and the JAX oracle."""
    live, fixed, w, gbar = _pair_inputs(Kl, Kg)
    T = 1.3
    blocks = []

    def per_block(a, b, wb):
        blocks.append((a.shape[0], b.shape[0]))
        return ref.mutual_kl_pair(a, b, wb, temperature=T)
    outs, grads = [], []
    for fn in (lambda a, b, wb: kl_mutual.blocked_pair(per_block, a, b, wb),
               lambda a, b, wb: ref.mutual_kl_pair(a, b, wb, temperature=T)):
        a = torch.from_numpy(live).requires_grad_(True)
        b = torch.from_numpy(fixed).requires_grad_(True)
        out = fn(a, b, torch.from_numpy(w))
        out.backward(torch.from_numpy(gbar))
        outs.append(out.detach())
        grads.append((a.grad, b.grad))
    M = kl_mutual.MAX_CLIENTS
    assert sorted(set(blocks)) == sorted(
        {(min(M, Kl - i), min(M, Kg - j))
         for i in range(0, Kl, M) for j in range(0, Kg, M)})
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    want = np.asarray(jref.mutual_kl_pair(jnp.asarray(live),
                                          jnp.asarray(fixed), jnp.asarray(w),
                                          T))
    np.testing.assert_allclose(outs[0].numpy(), want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("K", [9, 16])
def test_blocked_mutual_kl_square(K):
    """The readout's square case, w = (1 - I) / (K - 1), through the same
    blocking, against ``ref.mutual_kl`` and the JAX oracle."""
    logits, _, _, _ = _pair_inputs(K, 1, seed=1)
    x = torch.from_numpy(logits)
    w = (1.0 - torch.eye(K)) / (K - 1)
    got = kl_mutual.blocked_pair(
        lambda a, b, wb: ref.mutual_kl_pair(a, b, wb), x, x, w)
    torch.testing.assert_close(got, ref.mutual_kl(x), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.mutual_kl(jnp.asarray(logits))),
        atol=3e-5, rtol=3e-5)


def test_same_tensor_picks_the_square_kernel():
    """The forward's dispatch predicate: one storage viewed alike runs the
    square kernel; a copy, another view of the storage or another dtype
    over the same bytes runs the pair kernel."""
    x = torch.randn(3, 4, 16)
    assert kl_mutual.same_tensor(x, x)
    assert kl_mutual.same_tensor(x, x.detach())
    assert kl_mutual.same_tensor(x[:2], x.detach()[:2])
    for other in (x.clone(), x[:2], x[..., :8], x.transpose(1, 2),
                  x.view(torch.int32), x.as_strided(x.shape, (48, 16, 1)),
                  torch.randn(3, 4, 16)):
        assert not kl_mutual.same_tensor(x, other)


@pytest.mark.parametrize("fixed", ["detached", "clone"])
@pytest.mark.parametrize("K", [5, 16, 17])
def test_blocked_pair_square_on_the_diagonal(K, fixed):
    """``blocked_pair`` over (x, x.detach()) hands the square kernel the
    diagonal block pairs and the pair kernel the others; over (x,
    x.clone()) every block pair is a pair."""
    x = torch.randn(K, 2, 8)
    y = x.detach() if fixed == "detached" else x.clone()
    seen = []

    def per_block(a, b, wb):
        seen.append(kl_mutual.same_tensor(a, b))
        return torch.zeros(a.shape[:2])
    kl_mutual.blocked_pair(per_block, x, y, torch.ones(K, K))
    n = len(kl_mutual.client_blocks(K))
    diagonal = [L == F for L in range(n) for F in range(n)]
    assert seen == (diagonal if fixed == "detached" else [False] * n * n)


def _sparse_inputs(Kl, J, k, B=3, V=600, seed=0):
    rng = np.random.default_rng(seed)
    live = (2 * rng.standard_normal((Kl, B, V))).astype(np.float32)
    sent = torch.from_numpy(
        (2 * rng.standard_normal((J, B, V))).astype(np.float32))
    logp = torch.log_softmax(sent, -1)
    lp, idx = torch.topk(logp, k, dim=-1)
    idx = idx.to(torch.int32).numpy()
    idx[..., 1] = idx[..., 0]            # a repeated entry in every set
    w = rng.random((Kl, J)).astype(np.float32)
    gbar = rng.standard_normal((Kl, B)).astype(np.float32)
    return live, idx, lp.numpy(), w, gbar


@pytest.mark.parametrize("Kl,J,k", [(3, 3, 2048), (2, 70, 8), (1, 9, 500),
                                    (2, 1, 5000)])
def test_blocked_senders_match_unblocked(Kl, J, k):
    """The sparse KL past one launch's senders or entries, blocked by
    ``sender_blocks`` and driven by ``ref.sparse_kl_pair`` per block: the
    loss and the live gradient against the unblocked plain version and the
    JAX oracle."""
    V = max(600, k + 100)
    live, idx, lp, w, gbar = _sparse_inputs(Kl, J, k, V=V)
    blocks = []

    def per_block(a, i, lq, wb):
        blocks.append(i.shape[0])
        return ref.sparse_kl_pair(a, i, lq, wb)
    outs, grads = [], []
    for fn in (lambda *t: sparse_kl.blocked_senders(per_block, *t),
               ref.sparse_kl_pair):
        a = torch.from_numpy(live).requires_grad_(True)
        out = fn(a, torch.from_numpy(idx), torch.from_numpy(lp),
                 torch.from_numpy(w))
        out.backward(torch.from_numpy(gbar))
        outs.append(out.detach())
        grads.append(a.grad)
    sizes = [s.stop - s.start for s in sparse_kl.sender_blocks(J, k)]
    assert blocks == (sizes if len(sizes) > 1 else [J])
    assert sum(sizes) == J and all(
        n <= sparse_kl.MAX_SENDERS
        and (n == 1 or n * k <= sparse_kl.MAX_ENTRIES) for n in sizes)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-5)
    want = np.asarray(jref.sparse_kl_pair(
        jnp.asarray(live), jnp.asarray(idx), jnp.asarray(lp),
        jnp.asarray(w)))
    np.testing.assert_allclose(outs[0].numpy(), want, atol=3e-5, rtol=3e-5)
