"""The port's SparseDML path (``repro_torch``: the sparse-KL kernel's plain
version and its gradient, the top-k payload, the sparse half of
``core.mutual``, the ``SparseDML`` strategy and a K=3 session) against the
JAX package on the CPU.

Inputs come from numpy with a seed; JAX params cross through
``interop.params_from_numpy``.  The JAX side runs its plain versions and
its Pallas sparse-KL kernel in interpret mode, as its own suite does; the
port runs its plain versions (on CPU tensors the kernel wrapper takes
them).

Tolerances, all fp32:
  - the sparse KL and its gradient: atol/rtol 3e-5, the pin of
    ``tests/test_kernels_sparsekl.py`` (the same math, summed in another
    order);
  - the top-k payload: indices exactly equal (ties toward the lower index,
    as ``lax.top_k``), log-probs atol 1e-6;
  - a session's per-round losses atol 2e-5 and final params atol 1e-4, as
    in ``test_torch_train.py`` (AdamW divides by each gradient's RMS).
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Federation as JFederation
from repro.api import LMClients as JLMClients
from repro.api import SparseDML as JSparseDML
from repro.configs import get_reduced as jget_reduced
from repro.core import mutual as jmutual
from repro.kernels import ref as jref
from repro.kernels.sparse_kl import _sparse_kl_forward as jsparse_forward
from repro.kernels.sparse_kl import sparse_kl_topk as jsparse_kl
from repro_torch import interop
from repro_torch.api import Federation, LMClients, SparseDML, get_strategy
from repro_torch.checkpoint import flatten
from repro_torch.configs import get_reduced
from repro_torch.core import distributed as D
from repro_torch.core import mutual
from repro_torch.core.strategies import DML
from repro_torch.kernels import ops, ref, sparse_kl
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=3e-5, rtol=3e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _inputs(Kl, J, B, V, k, T=1.0, seed=0, dup=False, scale=3.0):
    """Live logits, the received top-k (idx, logp) of J senders' logits
    (JAX's ``lax.top_k`` of their log-softmax), weights and a cotangent,
    as numpy."""
    rng = np.random.default_rng(seed)
    live = (scale * rng.standard_normal((Kl, B, V))).astype(np.float32)
    senders = (scale * rng.standard_normal((J, B, V))).astype(np.float32)
    lp, idx = jax.lax.top_k(jax.nn.log_softmax(jnp.asarray(senders) / T), k)
    idx, lp = np.array(idx), np.array(lp)
    if dup:                         # senders share entries, one repeats
        idx[..., 1] = idx[..., 0]
        idx[-1, :, :k // 2] = idx[0, :, :k // 2]
    w = rng.uniform(0.1, 1.0, (Kl, J)).astype(np.float32)
    gbar = rng.standard_normal((Kl, B)).astype(np.float32)
    return live, idx.astype(np.int32), lp.astype(np.float32), w, gbar


def _jax_value_and_vjp(fn, x, cot):
    """fn(x) and its VJP with ``cot``, as one jitted JAX program (eager
    op-by-op dispatch costs seconds per call here)."""
    def both(a, c):
        out, vjp = jax.vjp(fn, a)
        return out, vjp(c)[0]
    return jax.jit(both)(jnp.asarray(x), jnp.asarray(cot))


# ---------------------------------------------------------------------------
# the sparse KL (the kernel's plain version) and its gradient

@pytest.mark.parametrize("Kl,J,B,V,k,T,dup,scale", [
    (2, 2, 8, 64, 8, 1.0, False, 3.0),
    (3, 2, 16, 100, 16, 0.5, False, 1.0),  # ragged V for the interpreted
    (4, 3, 7, 257, 16, 2.0, False, 3.0),   # ragged B and V
    (2, 2, 4, 90, 90, 1.0, False, 3.0),    # k == V: no uniform tail
    (1, 3, 6, 128, 8, 4.0, False, 3.0),    # Kl = 1 (the per-client form)
    (3, 3, 5, 200, 12, 1.3, True, 3.0),    # overlapping, repeated indices
])
def test_sparse_kl_pair_and_grad_match_jax(Kl, J, B, V, k, T, dup, scale):
    """``ref.sparse_kl_pair`` and its autograd gradient against the JAX
    oracle's VJP and against the Pallas kernel (interpret mode, 64-wide
    vocab blocks) with its custom VJP, on the same idx and logp.

    The T = 0.5 case draws its logits at scale 1: at scale 3 the senders'
    top 16 of 100 hold all but ~1.6e-6 of their mass, and the tail's
    c = log(clip(1 - sum e^logp)) then rests on a difference of a few
    ulps, which the two frameworks' orders of the 16-term sum move by
    ~6% (KL by 0.02).  That sensitivity is the formula's, in both
    packages, not a fault of the port."""
    live, idx, lp, w, gbar = _inputs(Kl, J, B, V, k, T, dup=dup,
                                     scale=scale)
    lt = torch.from_numpy(live).requires_grad_(True)
    got = ref.sparse_kl_pair(lt, torch.from_numpy(idx), torch.from_numpy(lp),
                             torch.from_numpy(w), temperature=T)
    got.backward(torch.from_numpy(gbar))
    args = (jnp.asarray(idx), jnp.asarray(lp), jnp.asarray(w))
    for fn in (lambda x: jref.sparse_kl_pair(x, *args, temperature=T),
               lambda x: jsparse_kl(x, *args, temperature=T, block_b=4,
                                    block_v=64, interpret=True)):
        want, dlive = _jax_value_and_vjp(fn, live, gbar)
        _close(got, want)
        _close(lt.grad, dlive)


def _sparse_forward_model(live, idx, logp, w, T, lanes=4, warps=2,
                          width=8):
    """The sparse forward's order of arithmetic on fp32 logits live (Kl, B,
    V): per row, ``lanes * warps`` threads stream tiles of ``width``
    elements (thread t takes tiles t, t + threads, ...) carrying (m, A, U)
    in log2 units (y = x c, c = log2(e) / T; A = sum 2^(y - m), U = sum
    2^(y - m) (y - m)), one rescale a tile; the states merge by a
    butterfly within each warp (lane 0's result), then warp after warp;
    Z = ln 2 (m + log2 A) and -H = ln 2 (U / A - log2 A).  Then each
    sender's s, cross and sum e^logp at the received indices.  Returns
    out (Kl, B) and stats (3, Kl, B) = Z, -H, C1."""
    Kl, B, V = live.shape
    J, _, k = idx.shape
    c = torch.tensor(math.log2(math.e) / T, dtype=torch.float32)
    ln2 = math.log(2)
    threads = lanes * warps
    out = torch.zeros(Kl, B)
    stats = torch.zeros(3, Kl, B)

    def merge(s1, s2):
        (m1, a1, u1), (m2, a2, u2) = s1, s2
        mn = torch.maximum(m1, m2)
        d1, d2 = m1 - mn, m2 - mn
        e1, e2 = torch.exp2(d1), torch.exp2(d2)
        return mn, a1 * e1 + a2 * e2, e1 * (u1 + d1 * a1) + e2 * (u2 + d2 * a2)
    for i in range(Kl):
        for b in range(B):
            row = live[i, b]
            states = []
            for t in range(threads):
                m, a, u = (torch.tensor(-1e30), torch.tensor(0.0),
                           torch.tensor(0.0))
                for v0 in range(t * width, V, threads * width):
                    tile = row[v0:v0 + width]
                    mx = torch.maximum(m, tile.max() * c)
                    d = m - mx
                    sc = torch.exp2(d)
                    u, a, m = sc * (u + d * a), a * sc, mx
                    y = tile * c - m
                    e = torch.exp2(y)
                    a, u = a + e.sum(), u + (e * y).sum()
                states.append((m, a, u))
            merged = []
            for wp in range(warps):      # butterfly: lane 0's view
                lane = states[wp * lanes:(wp + 1) * lanes]
                step = lanes // 2
                while step:
                    lane = [merge(lane[q], lane[q ^ step])
                            for q in range(lanes)]
                    step //= 2
                merged.append(lane[0])
            m, a, u = merged[0]
            for st in merged[1:]:
                m, a, u = merge((m, a, u), st)
            z = ln2 * (m + torch.log2(a))
            neg_h = ln2 * (u / a - torch.log2(a))
            o = c1 = 0.0
            for j in range(J):
                pa = torch.exp(row[idx[j, b].long()] / T - z)
                lq = logp[j, b]
                s_, cross = pa.sum(), (pa * lq).sum()
                cj = torch.log(torch.clamp(1 - torch.exp(lq).sum(), 1e-9, 1)
                               / max(V - k, 1))
                o = o + w[i, j] * (neg_h - cj * (1 - s_) - cross)
                c1 = c1 + w[i, j] * (cj * s_ - cross)
            out[i, b] = o
            stats[:, i, b] = torch.stack([z, neg_h, torch.as_tensor(c1)])
    return out, stats


def _sparse_backward_from_stats(live, idx, logp, w, stats, gbar, T):
    """The sparse backward's formula from the forward's stats (what the
    backward kernel reads): dlive = s gbar p [R (lp - (-H)) - C1] + s gbar
    p sum_j w_ij (c_j a^j_v - l^j_v), with a^j_v the multiplicity of v in
    sender j's set and l^j_v the sum of its log-probs there."""
    Kl, B, V = live.shape
    J, _, k = idx.shape
    z, neg_h, c1 = stats
    lp = live / T - z[..., None]
    p = torch.exp(lp)
    cj = torch.log(torch.clamp(1 - torch.exp(logp).sum(-1), 1e-9, 1)
                   / max(V - k, 1))                            # (J, B)
    mult = torch.zeros(J, B, V).scatter_add_(-1, idx.long(),
                                             torch.ones(J, B, k))
    lsum = torch.zeros(J, B, V).scatter_add_(-1, idx.long(), logp)
    sparse = torch.einsum("ij,jbv->ibv", w, cj[..., None] * mult - lsum)
    r = w.sum(1)[:, None, None]
    dense = r * (lp - neg_h[..., None]) - c1[..., None]
    return (gbar / T)[..., None] * p * (dense + sparse)


@pytest.mark.parametrize("Kl,J,B,V,k,T,dup", [
    (3, 3, 4, 301, 16, 1.0, False),     # the path's Kl = J, ragged V
    (1, 2, 3, 200, 8, 2.0, True),       # Kl = 1, overlapping sets
    (2, 3, 3, 90, 90, 0.7, False),      # k = V: no uniform tail
])
def test_sparse_forward_arithmetic_matches_jax(Kl, J, B, V, k, T, dup):
    """The sparse forward's order of arithmetic (log2 state, the
    butterfly-then-warp merge, statistics in natural units), modelled in
    fp32 on the CPU: out against JAX's interpreted ``_sparse_kl_forward``;
    Z, -H and C1 against the plain version; and the backward's formula fed
    those statistics against autograd of ``ref.sparse_kl_pair``."""
    live, idx, lp, w, gbar = _inputs(Kl, J, B, V, k, T, seed=5, dup=dup,
                                     scale=2.0)
    lt, it, lpt, wt, gt = (torch.from_numpy(a)
                           for a in (live, idx, lp, w, gbar))
    out, stats = _sparse_forward_model(lt, it, lpt, wt, T)
    _close(out, jsparse_forward(jnp.asarray(live), jnp.asarray(idx),
                                jnp.asarray(lp), jnp.asarray(w), T, True, 4,
                                64))
    lpl = torch.log_softmax(lt / T, -1)
    p_at = torch.gather(lpl.exp()[:, None].expand(Kl, J, B, V), -1,
                        it.long()[None].expand(Kl, J, B, k))
    cj = torch.log(torch.clamp(1 - lpt.exp().sum(-1), 1e-9, 1)
                   / max(V - k, 1))
    c1 = torch.einsum("ij,ijb->ib", wt, cj[None] * p_at.sum(-1)
                      - (p_at * lpt[None]).sum(-1))
    _close(stats[0], torch.logsumexp(lt / T, -1))
    _close(stats[1], (lpl.exp() * lpl).sum(-1))
    _close(stats[2], c1)
    a = lt.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        ref.sparse_kl_pair(a, it, lpt, wt, temperature=T), a, gt)
    _close(_sparse_backward_from_stats(lt, it, lpt, wt, stats, gt, T), want)


def test_ops_sparse_mutual_kl_dispatch():
    """impl "ref" is the plain version; impl "cuda" refuses CPU tensors and
    an unknown impl is an error, never a fallback; the wrapper takes the
    plain version on CPU tensors and counts no launch."""
    live, idx, lp, w, _ = _inputs(2, 2, 3, 50, 4)
    args = [torch.from_numpy(a) for a in (live, idx, lp, w)]
    want = ref.sparse_kl_pair(*args, temperature=1.5)
    _close(ops.sparse_mutual_kl(*args, temperature=1.5, impl="ref"), want,
           atol=0, rtol=0)
    before = (sparse_kl.launches, sparse_kl.bwd_launches)
    _close(sparse_kl.sparse_kl_topk(*args, temperature=1.5), want, atol=0,
           rtol=0)
    assert (sparse_kl.launches, sparse_kl.bwd_launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.sparse_mutual_kl(*args, impl="cuda")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.sparse_mutual_kl(*args, impl="pallas")


# ---------------------------------------------------------------------------
# the payload: top-k in lax.top_k's order

def _topk_both(logits, k, T=1.0):
    got_i, got_v = mutual.topk_predictions(torch.from_numpy(logits), k, T)
    want_i, want_v = jmutual.topk_predictions(jnp.asarray(logits), k, T)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(_np(got_i), np.asarray(want_i))
    _close(got_v, want_v, atol=1e-6, rtol=0)
    return _np(got_i)


def test_topk_tie_breaking_matches_lax():
    """The inputs of the JAX suite's ``test_topk_tie_breaking_deterministic``:
    all tied (the first k indices), and a tied pair in index order."""
    idx = _topk_both(np.zeros((2, 4, 32), np.float32), 6)
    np.testing.assert_array_equal(idx, np.broadcast_to(np.arange(6),
                                                       (2, 4, 6)))
    t = np.zeros((1, 1, 32), np.float32)
    t[0, 0, 10] = t[0, 0, 20] = 1.0
    assert list(_topk_both(t, 3)[0, 0, :2]) == [10, 20]


@pytest.mark.parametrize("k,T", [(8, 1.0), (64, 1.0), (64, 2.0)])
def test_topk_matches_lax_on_bf16_ties(k, T):
    """bf16-rounded random logits over a 4096-wide vocabulary tie often,
    inside the top k and across its k-th place: the indices equal
    ``lax.top_k``'s exactly."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 16, 4096))
                         .astype(np.float32)).to(torch.bfloat16).float()
    x = x.numpy()
    kth = -np.sort(-x, axis=-1)[..., k - 1:k]
    assert ((x == kth).sum(-1) > 1).any()       # ties at the k-th place
    _topk_both(x, k, T)


# ---------------------------------------------------------------------------
# the sparse half of core.mutual

def test_sparse_kl_to_received_matches_jax():
    """One client against J = 2 received sets: value and gradient at
    "ref" against JAX's plain path and its interpreted kernel."""
    live, idx, lp, _, _ = _inputs(3, 3, 5, 96, 12, seed=4)
    x = torch.from_numpy(live[0]).requires_grad_(True)
    got = mutual.sparse_kl_to_received(x, torch.from_numpy(idx[1:]),
                                       torch.from_numpy(lp[1:]), 1.3,
                                       impl="ref")
    got.sum().backward()
    for impl in ("ref", "interpret"):
        f = lambda a: jmutual.sparse_kl_to_received(       # noqa: E731
            a, jnp.asarray(idx[1:]), jnp.asarray(lp[1:]), 1.3, impl=impl)
        want, grad = _jax_value_and_vjp(f, live[0], np.ones(5, np.float32))
        _close(got, want)
        _close(x.grad, grad)


def test_sparse_mutual_kl_loss_matches_jax():
    """The stacked SparseDML Eq.-2 loss against each client's own top-k
    set: values and gradient at "ref" against JAX's plain path and its
    interpreted kernel."""
    rng = np.random.default_rng(5)
    stack = (3 * rng.standard_normal((3, 6, 96))).astype(np.float32)
    idx, lp = jmutual.topk_predictions(jnp.asarray(stack), 12)
    x = torch.from_numpy(stack).requires_grad_(True)
    got = mutual.sparse_mutual_kl_loss(x, torch.from_numpy(np.array(idx)),
                                       torch.from_numpy(np.array(lp)),
                                       impl="ref")
    got.sum().backward()
    for impl in ("ref", "interpret"):
        f = lambda a: jmutual.sparse_mutual_kl_loss(       # noqa: E731
            a, idx, lp, impl=impl)
        want, grad = _jax_value_and_vjp(f, stack, np.ones(3, np.float32))
        _close(got, want)
        _close(x.grad, grad)
    assert mutual.sparse_share_bytes(3, 16, 8) == \
        jmutual.sparse_share_bytes(3, 16, 8)


# ---------------------------------------------------------------------------
# the SparseDML session, round by round

SESSIONS = {"ref": ("ref", 3), "interpret": ("interpret", 2)}


def _jax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_sessions():
    """The JAX SparseDML(k=8) sessions (run once), with the params they
    started from."""
    out = {}
    for name, (impl, rounds) in SESSIONS.items():
        pop = JLMClients(jget_reduced("qwen3-4b"), n_clients=3,
                         rounds=rounds, batch=2, seq=16, seed=0,
                         kernel_impl=impl)
        start = _jax_numpy(pop.state_dict())
        fed = JFederation(pop, JSparseDML(k=8))
        fed.run()
        out[name] = (start, fed)
    return out


def _port_population(start, rounds):
    pop = LMClients(get_reduced("qwen3-4b"), n_clients=3, rounds=rounds,
                    batch=2, seq=16, seed=0, device="cpu")
    pop.load_state_dict(interop.params_from_numpy(start, device="cpu"), {})
    return pop


@pytest.mark.parametrize("name", list(SESSIONS))
def test_sparse_dml_session_matches_jax(jax_sessions, name):
    """K=3 reduced qwen3-4b SparseDML(k=8) sessions from JAX-initialised
    params: comm bytes, per-round private_loss, public_ce and kld_avg, and
    the final params."""
    start, jfed = jax_sessions[name]
    rounds = SESSIONS[name][1]
    fed = Federation(_port_population(start, rounds), SparseDML(k=8))
    fed.run()
    assert len(fed.history.rounds) == len(jfed.history.rounds) == rounds
    for got, want in zip(fed.history.rounds, jfed.history.rounds):
        assert got.participants == want.participants
        assert got.comm_bytes == want.comm_bytes > 0
        _close(got.client_loss, want.client_loss, atol=2e-5, rtol=0)
        _close(got.public_ce, want.public_ce, atol=2e-5, rtol=0)
        _close(got.kl_loss, want.kl_loss, atol=2e-5, rtol=0)
    got, want = flatten(fed.population.client_params), \
        flatten(_jax_numpy(jfed.population.client_params))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], atol=1e-4, rtol=0)


def test_sparse_dml_refuses_partial_participation():
    pop = LMClients(get_reduced("qwen3-4b"), n_clients=3, rounds=1, batch=2,
                    seq=8, device="cpu")
    with pytest.raises(ValueError, match="partial participation"):
        Federation(pop, SparseDML(k=8), participation=2).run()


def test_dml_total_loss_sparse_received_sets():
    """``dml_total_loss`` with ``sparse_k`` takes the top-k sets of its own
    detached public logits unless given the ``received`` ones (what
    ``chip_smoke.py`` holds fixed across impls), and refuses partial
    participation."""
    cfg = get_reduced("qwen3-4b")
    pop = LMClients(cfg, n_clients=3, rounds=1, batch=2, seq=8,
                    device="cpu")
    toks, pub = pop._private_batch(0), pop._public_batch(0)
    own = mutual.topk_predictions(
        tfm.forward_clients(pop.client_params, cfg, pub, impl="ref")
        .reshape(3, -1, cfg.vocab_size), 8)
    loss = lambda **kw: D.dml_total_loss(                 # noqa: E731
        pop.client_params, cfg, toks, pub, sparse_k=8, impl="ref", **kw)
    total, m = loss()
    _close(loss(received=own)[0], total, atol=0, rtol=0)
    other = (torch.roll(own[0], 1, dims=0), torch.roll(own[1], 1, dims=0))
    assert not torch.allclose(loss(received=other)[1]["kld_avg"],
                              m["kld_avg"])
    with pytest.raises(ValueError, match="partial participation"):
        D.dml_total_loss(pop.client_params, cfg, toks, pub, [1.0, 0.0, 1.0],
                         sparse_k=8, impl="ref")


def test_sparse_dml_strategy():
    """The CLI id resolves with its knob, the payload is marked sparse, and
    k must be positive."""
    st = get_strategy("sparse-dml", k=8, kl_weight=0.5)
    assert isinstance(st, SparseDML) and st.sparse_k == 8
    assert st.kl_weight == 0.5 and DML.sparse_k == 0

    class Pop:
        def public_payload(self, r):
            return r
    assert st.round_payload(Pop(), 3, [0, 1]).kind == "sparse-predictions"
    assert DML().round_payload(Pop(), 3, [0, 1]).kind == "predictions"
    with pytest.raises(ValueError, match="k > 0"):
        SparseDML(k=0)


def test_train_cli_sparse_dml_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--method", "dml",
         "--clients", "3", "--steps", "2", "--batch", "2", "--seq", "16",
         "--strategy", "sparse-dml", "--sparse-k", "8", "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # 3 clients x 16 public positions x k 8 x 8 bytes, up and down, a round
    assert "total_comm_bytes=12288" in proc.stdout, proc.stdout
