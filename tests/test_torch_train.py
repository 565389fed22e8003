"""The port's training path (``repro_torch``: the Eq.-2 KL, the attention
backward, AdamW, the model loss, the DML steps and the ``Federation``
session) against the JAX package on the CPU.

Inputs come from numpy with a seed; JAX params cross through
``interop.params_from_numpy``.  The JAX side runs its plain versions and
its Pallas kernels in interpret mode, as its own suite does; the port runs
its plain versions (on CPU tensors the kernel wrappers take them).

Tolerances, all fp32:
  - KL values and gradients, attention gradients, one loss and its
    gradient: atol/rtol 1e-5 -- the same math, summed in another order;
  - AdamW after 3 steps: atol 1e-6 on params and moments;
  - a session's per-round losses: atol 2e-5; its final params: atol 1e-4.
    AdamW divides each gradient by its own running RMS, so an element whose
    gradient is at rounding level can move by up to lr per step in either
    package; 1e-4 is a sixth of the largest step these sessions take
    (lr 1e-3, 5 warmup steps).
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

from repro.api import DML as JDML
from repro.api import Federation as JFederation
from repro.api import LMClients as JLMClients
from repro.configs import get_reduced as jget_reduced
from repro.core import distributed as jD
from repro.core import mutual as jmutual
from repro.data.federated import sample_participants as jsample
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.kl_mutual import kl_mutual as jkl_mutual
from repro.kernels.kl_mutual import kl_mutual_pair as jkl_pair
from repro.models import transformer as jtfm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro_torch import interop
from repro_torch.checkpoint import flatten
from repro_torch.api import DML, Federation, LMClients, get_strategy
from repro_torch.configs import get_reduced
from repro_torch.core import distributed as D
from repro_torch.core import mutual, stacking
from repro_torch.data.federated import sample_participants
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as tfm
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm)
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _jax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _trees_close(got, want, **tol):
    """Leaf by leaf, matched by their '/'-joined paths (JAX flattens dicts
    in sorted-key order, the port in insertion order)."""
    got, want = flatten(got), flatten(_jax_numpy(want))
    assert sorted(got) == sorted(want)
    for key in want:
        if tol:
            _close(got[key], want[key], **tol)
        else:
            np.testing.assert_array_equal(_np(got[key]), want[key], key)


# ---------------------------------------------------------------------------
# (a) the Eq.-2 KL and its gradients

def _kl_inputs(K, V, B=5, seed=0):
    rng = np.random.default_rng(seed)
    live = (2 * rng.standard_normal((K, B, V))).astype(np.float32)
    fixed = (2 * rng.standard_normal((K, B, V))).astype(np.float32)
    gbar = rng.standard_normal((K, B)).astype(np.float32)
    return live, fixed, gbar


@pytest.mark.parametrize("K,part,T,V", [
    (2, None, 1.0, 256),          # two clients, V a multiple of the block
    (3, [1, 0, 1], 1.7, 300),     # masked weights (M < K), T != 1, ragged V
    (4, None, 0.5, 517),          # four clients, ragged V
    (4, [1, 1, 0, 1], 1.0, 129),  # masked, one column past the block
])
def test_mutual_kl_pair_and_grads_match_jax(K, part, T, V):
    """Values and both gradients of ``ref.mutual_kl_pair`` against the JAX
    oracle's VJP and against the Pallas kernel (interpret mode, 128-wide
    vocab blocks) with its custom VJP."""
    live, fixed, gbar = _kl_inputs(K, V)
    w = np.array(jmutual._pair_mask(K, part))
    _close(mutual._pair_mask(K, part), w, atol=0, rtol=0)
    lt, ft = (torch.from_numpy(a).requires_grad_(True) for a in (live, fixed))
    got = ref.mutual_kl_pair(lt, ft, torch.from_numpy(w), temperature=T)
    got.backward(torch.from_numpy(gbar))
    for fn in (lambda a, b: jref.mutual_kl_pair(a, b, jnp.asarray(w), T),
               lambda a, b: jkl_pair(a, b, jnp.asarray(w), temperature=T,
                                     block_v=128, interpret=True)):
        want, vjp = jax.vjp(fn, jnp.asarray(live), jnp.asarray(fixed))
        dlive, dfixed = vjp(jnp.asarray(gbar))
        _close(got, want)
        _close(lt.grad, dlive)
        _close(ft.grad, dfixed)


@pytest.mark.parametrize("K,T,V", [(2, 1.0, 130), (3, 1.3, 300),
                                   (4, 0.7, 64)])
def test_mutual_kl_matches_jax_and_the_pair_identity(K, T, V):
    """``ref.mutual_kl`` against the JAX oracle and the forward-only Pallas
    kernel (interpret), and the identity kernel 3 runs through:
    mutual_kl(x) == mutual_kl_pair(x, x, (1 - I) / (K - 1))."""
    x, _, _ = _kl_inputs(K, V, seed=1)
    got = ref.mutual_kl(torch.from_numpy(x), temperature=T)
    _close(got, jref.mutual_kl(jnp.asarray(x), T))
    _close(got, jkl_mutual(jnp.asarray(x), temperature=T, block_v=128,
                           interpret=True))
    w = (1 - torch.eye(K)) / (K - 1)
    _close(got, ref.mutual_kl_pair(torch.from_numpy(x), torch.from_numpy(x),
                                   w, temperature=T))
    _close(ops.mutual_kl(torch.from_numpy(x), temperature=T, impl="ref"),
           got, atol=0, rtol=0)
    _close(mutual.mutual_kl_eval(torch.from_numpy(x), T, impl="ref"), got,
           atol=0, rtol=0)


@pytest.mark.parametrize("K,part,T,V", [
    (3, [1, 1, 0], 1.5, 300),     # the DML round's mask, one client out
    (4, [1, 0, 1, 1], 0.5, 517),  # ragged V against the vector width
    (2, None, 1.0, 130),
    (5, [1, 1, 1, 0, 1], 1.7, 64),
])
def test_square_identity_under_masked_weights(K, part, T, V):
    """The square case as the DML round runs it: ``ref.mutual_kl_pair(x,
    x.detach(), _pair_mask(K, part))`` (what the square kernel computes)
    against JAX's ``_kl_pair_kernel`` in interpret mode with fixed =
    stop_gradient(live), as JAX's training calls it: values and the live
    gradient."""
    x, _, gbar = _kl_inputs(K, V, seed=3)
    w = mutual._pair_mask(K, part)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ref.mutual_kl_pair(xt, xt.detach(), w, temperature=T)
    got.backward(torch.from_numpy(gbar))
    want, vjp = jax.vjp(lambda a: jkl_pair(
        a, jax.lax.stop_gradient(a), jnp.asarray(w.numpy()), temperature=T,
        block_v=128, interpret=True), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(gbar))
    _close(got, want)
    _close(xt.grad, dx)


def _square_kernel_model(x, w, T, threads=4, width=8, return_lse=False):
    """The square kernel's arithmetic order on fp32 logits x (K, B, V):
    per row, ``threads`` streams over tiles of ``width`` elements (thread t
    takes tiles t, t + threads, ...); a tile takes its max in log2 units
    (x c, c = log2(e) / T), rescales the thread's partition and cross sums
    once, then adds e = 2^(x c - m) and e_i (x_i - x_j) on the raw logits;
    the threads' states merge pairwise in the kernel's butterfly order, and
    KL_ij = (Z_j - Z_i) + T_ij / (T A_i) with Z = ln 2 (m + log2 A).
    Returns out, or (out, Z) with ``return_lse``."""
    K, B, V = x.shape
    c = torch.tensor(math.log2(math.e) / T, dtype=torch.float32)
    out, lse = torch.zeros(K, B), torch.zeros(K, B)
    for b in range(B):
        states = []
        for t in range(threads):
            m = torch.full((K,), -1e30)
            a = torch.zeros(K)
            cross = torch.zeros(K, K)
            for v0 in range(t * width, V, threads * width):
                tile = x[:, b, v0:v0 + width]                  # (K, n)
                mx = torch.maximum(m, tile.max(-1).values * c)
                sc = torch.exp2(m - mx)
                a, cross, m = a * sc, cross * sc[:, None], mx
                e = torch.exp2(tile * c - m[:, None])
                a = a + e.sum(-1)
                cross = cross + torch.einsum(
                    "in,ijn->ij", e, tile[:, None] - tile[None])
            states.append((m, a, cross))
        step = threads // 2
        while step:                      # butterfly merge, as thread 0 sees it
            for t in range(step):
                (m1, a1, t1), (m2, a2, t2) = states[t], states[t + step]
                mn = torch.maximum(m1, m2)
                s1, s2 = torch.exp2(m1 - mn), torch.exp2(m2 - mn)
                states[t] = (mn, a1 * s1 + a2 * s2,
                             t1 * s1[:, None] + t2 * s2[:, None])
            step //= 2
        m, a, cross = states[0]
        z = math.log(2) * (m + torch.log2(a))
        kl = (z[None] - z[:, None]) + cross / (T * a[:, None])
        out[:, b] = (w * kl * (1 - torch.eye(K))).sum(1)
        lse[:, b] = z
    return (out, lse) if return_lse else out


@pytest.mark.parametrize("K,part,T,V", [
    (3, [1, 1, 0], 1.5, 300), (1, None, 1.0, 77), (4, None, 0.5, 129),
    (8, [1, 1, 1, 1, 1, 1, 1, 0], 1.7, 200)])
def test_square_kernel_arithmetic_matches_jax(K, part, T, V):
    """The square kernel's order of arithmetic (log2 units, one rescale a
    tile, the cross term on raw logits, the butterfly merge), modelled in
    fp32 on the CPU, against the JAX oracle ``mutual_kl_pair(x, x, w)``
    and against JAX's interpreted ``_kl_pair_kernel`` with fixed =
    stop_gradient(live)."""
    x, _, _ = _kl_inputs(K, V, seed=4)
    w = mutual._pair_mask(K, part)
    got = _square_kernel_model(torch.from_numpy(x), w, T)
    jw = jnp.asarray(w.numpy())
    _close(got, jref.mutual_kl_pair(jnp.asarray(x), jnp.asarray(x), jw, T))
    _close(got, jkl_pair(jnp.asarray(x), jax.lax.stop_gradient(
        jnp.asarray(x)), jw, temperature=T, block_v=128, interpret=True))


def _square_bwd_model(x, w, T, out, z, gbar, want_fixed=False):
    """The square backward's order of arithmetic on fp32 logits x (K, B, V),
    from the forward's out and logsumexp z (K, B): per-row constants
    kap_i = -R_i Z_i + sum_{j != i} w_ij Z_j - out_i (R_i = sum_{j != i}
    w_ij), p_i = 2^(x_i c - Z_i log2 e) in log2 units, the cross term on the
    raw logits, dlive_i = s gbar_i p_i (s R_i x_i - s sum_{j != i} w_ij x_j
    + kap_i); with ``want_fixed`` also the fixed side's gradient of the same
    x, dfixed_j = s col_j p_j - s sum_{i != j} w_ij gbar_i p_i (q = p),
    col_j = sum_{i != j} w_ij gbar_i.  Returns dlive, or dlive + dfixed."""
    K = x.shape[0]
    s = 1.0 / T
    c = torch.tensor(math.log2(math.e) / T, dtype=torch.float32)
    off = w * (1 - torch.eye(K))                     # pairs i = j left out
    r = off.sum(1)
    kap = -r[:, None] * z + off @ z - out
    p = torch.exp2(x * c - (z * math.log2(math.e))[..., None])
    t = (s * r)[:, None, None] * x + kap[..., None] \
        + torch.einsum("ij,jbv->ibv", -s * off, x)
    grad = (s * gbar)[..., None] * p * t
    if want_fixed:
        col = s * torch.einsum("ij,ib->jb", off, gbar)
        grad = grad + col[..., None] * p + torch.einsum(
            "ij,ibv->jbv", -s * off, gbar[..., None] * p)
    return grad


@pytest.mark.parametrize("want_fixed", [False, True])
@pytest.mark.parametrize("weights", ["masked", "uniform"])
@pytest.mark.parametrize("K,T,V", [(1, 0.7, 77), (2, 1.5, 130),
                                   (3, 0.7, 300), (4, 1.5, 203)])
def test_square_backward_arithmetic_matches_jax(K, T, V, weights,
                                                want_fixed):
    """The square backward's order of arithmetic (log2 units, the cross
    term on raw logits, the per-row constant kap), modelled in fp32 on the
    CPU from the square forward model's out and logsumexp, against
    ``jax.vjp`` of JAX's interpreted ``kl_mutual_pair(x,
    stop_gradient(x), w)`` (the DML round's call: dlive) or of
    ``kl_mutual_pair(x, x, w)`` (both sides on one tensor: dlive +
    dfixed), with the participation mask or w = (1 - I) / (K - 1), V not a
    multiple of 8.  Relative norm error 1e-5."""
    x, _, gbar = _kl_inputs(K, V, seed=6)
    part = [1] * max(K - 1, 1) + [0] if weights == "masked" else None
    w = mutual._pair_mask(K, part[:K] if part else None)
    xt = torch.from_numpy(x)
    out, z = _square_kernel_model(xt, w, T, return_lse=True)
    got = _square_bwd_model(xt, w, T, out, z, torch.from_numpy(gbar),
                            want_fixed).numpy()
    jw = jnp.asarray(w.numpy())

    def fn(a):
        b = a if want_fixed else jax.lax.stop_gradient(a)
        return jkl_pair(a, b, jw, temperature=T, block_v=128, interpret=True)
    want = np.asarray(jax.jit(lambda a, cot: jax.vjp(fn, a)[1](cot)[0])(
        jnp.asarray(x), jnp.asarray(gbar)))
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


@pytest.mark.parametrize("part", [None, [1, 1, 0]])
def test_mutual_kl_loss_and_received_match_jax(part):
    """The dense half of ``core.mutual`` with the fixed side detached: the
    loss and its gradient, and ``kl_to_received``."""
    live, _, _ = _kl_inputs(3, 200, seed=2)
    lt = torch.from_numpy(live).requires_grad_(True)
    got = mutual.mutual_kl_loss(lt, 1.5, part_mask=part, impl="ref")
    got.sum().backward()
    want = jmutual.mutual_kl_loss(jnp.asarray(live), 1.5, part_mask=part,
                                  impl="ref")
    grad = jax.grad(lambda a: jnp.sum(jmutual.mutual_kl_loss(
        a, 1.5, part_mask=part, impl="interpret")))(jnp.asarray(live))
    _close(got, want)
    _close(lt.grad, grad)
    rec = mutual.kl_to_received(torch.from_numpy(live[0]),
                                torch.from_numpy(live[1:]), 1.5, impl="ref")
    _close(rec, jmutual.kl_to_received(jnp.asarray(live[0]),
                                       jnp.asarray(live[1:]), 1.5))


# ---------------------------------------------------------------------------
# (b) the attention backward

@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window", [
    (2, 96, 4, 2, 32, None),      # GQA 2:1
    (1, 150, 4, 1, 16, None),     # MQA, ragged S (two 128-blocks)
    (2, 150, 4, 2, 32, 33),       # sliding window
    (1, 130, 2, 2, 32, 1),        # window of one
])
def test_attention_grads_match_jax_flash_interpret(B, S, Hq, Hkv, hd,
                                                   window):
    """dq, dk, dv of ``ops.attention(impl="ref")`` (autograd of the plain
    version: the CUDA backward's plain version) against the VJP of the JAX
    Pallas flash kernel in interpret mode (128x128 blocks)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, Hq, hd), np.float32)
    k = rng.standard_normal((B, S, Hkv, hd), np.float32)
    v = rng.standard_normal((B, S, Hkv, hd), np.float32)
    dout = rng.standard_normal((B, S, Hq, hd), np.float32)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.attention(qt, kt, vt, causal=True, window=window, impl="ref")
    out.backward(torch.from_numpy(dout))

    def jfn(a, b, c):
        tr = lambda t: t.transpose(0, 2, 1, 3)       # noqa: E731
        return tr(jflash(tr(a), tr(b), tr(c), causal=True, window=window,
                         interpret=True))
    want, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq, dk, dv = vjp(jnp.asarray(dout))
    _close(out, want)
    _close(qt.grad, dq)
    _close(kt.grad, dk)
    _close(vt.grad, dv)


# ---------------------------------------------------------------------------
# (c) AdamW

def _opt_tree(rng):
    """Leaf names that exercise every ``_wd_mask`` rule: decayed matrices,
    names containing "norm", each exact skip name, and a "norm" dict key
    above a matrix."""
    shapes = {"w_qkv": (4, 6), "lm_head": (6, 3), "norm1": (4,),
              "final_norm": (4,), "q_norm": (2,), "bias": (3,),
              "b_qkv": (6,), "A_log": (2,), "D": (2,), "dt_bias": (2,),
              "conv_b": (5,), "b": (3,), "embed": (7, 4)}
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    tree["norm"] = {"w": rng.standard_normal((3, 3)).astype(np.float32)}
    tree["mixer"] = {"w_o": rng.standard_normal((2, 4)).astype(np.float32),
                     "b": rng.standard_normal((4,)).astype(np.float32)}
    return tree


@pytest.mark.parametrize("clip_norm,schedule", [(0.5, "cosine"),
                                                (None, "constant")])
def test_adamw_update_matches_jax(clip_norm, schedule):
    """Three steps of ``adamw_update`` against JAX: one global-norm clip
    over the whole tree (active: the gradients' norm is far above 0.5),
    the weight-decay name rules, the schedules and the bias corrections."""
    rng = np.random.default_rng(4)
    params = _opt_tree(rng)
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm, warmup=2,
              total_steps=5, schedule=schedule)
    jp, jo = jax.tree.map(jnp.asarray, params), jadamw_init(params)
    tp = interop.params_from_numpy(params, device="cpu")
    to = adamw_init(tp)
    jupdate = jax.jit(jadamw_update, static_argnums=3)
    for step in range(3):
        grads = jax.tree.map(lambda a: (3 * rng.standard_normal(a.shape))
                             .astype(np.float32), params)
        jp, jo, jm = jupdate(jp, jax.tree.map(jnp.asarray, grads), jo,
                             JAdamWConfig(**kw))
        tp, to, tm = adamw_update(tp, interop.params_from_numpy(
            grads, device="cpu"), to, AdamWConfig(**kw))
        _close(tm["grad_norm"], jm["grad_norm"], atol=1e-5, rtol=1e-6)
        _close(tm["lr"], jm["lr"], atol=0, rtol=1e-6)
    assert int(to["step"]) == int(jo["step"]) == 3
    for got, want in ((tp, jp), (to["mu"], jo["mu"]), (to["nu"], jo["nu"])):
        _trees_close(got, want, atol=1e-6, rtol=1e-6)
    clipped, norm = clip_by_global_norm(
        interop.params_from_numpy(grads, device="cpu"), 0.5)
    jclipped, jnorm = jclip(jax.tree.map(jnp.asarray, grads), 0.5)
    _close(norm, jnorm, atol=1e-5, rtol=1e-6)
    _trees_close(clipped, jclipped, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the model loss and the fused DML round's loss

@pytest.fixture(scope="module")
def small():
    """Reduced qwen3-4b, 3 JAX-initialised clients, seeded batches."""
    cfg = jget_reduced("qwen3-4b")
    jparams = jD.stacked_init(jax.random.PRNGKey(1), cfg, 3)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 2, 24)).astype(np.int32)
    pub = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    return cfg, jparams, toks, pub


@pytest.mark.parametrize("ce_impl,remat", [("dense", True),
                                           ("chunked", False)])
def test_loss_fn_and_grads_match_jax(small, ce_impl, remat):
    """``loss_fn`` (dense and the vocab-chunked CE, with and without remat)
    and its gradient for one client against JAX's."""
    cfg, jparams, toks, _ = small
    jp = jax.tree.map(lambda t: t[0], jparams)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, cfg, jnp.asarray(toks[0]), remat=remat,
                               ce_impl=ce_impl, impl="ref"),
        has_aux=True))(jp)
    tp = interop.params_from_numpy(_jax_numpy(jp), device="cpu")
    tt = torch.as_tensor(toks[0], dtype=torch.long)
    tcfg = get_reduced("qwen3-4b")
    got, gm, grads = D.value_and_grad(
        lambda p: tfm.loss_fn(p, tcfg, tt, remat=remat, ce_impl=ce_impl,
                              impl="ref"), tp)
    _close(got, want)
    _close(gm["ce"], wm["ce"])
    _trees_close(grads, wg, atol=1e-5, rtol=1e-4)


def _jax_dml_total(cfg, toks, pub, part_mask, impl):
    """The JAX ``make_dml_train_step``'s ``total_loss`` (written out: the
    factory keeps it in a closure)."""
    def total(sp):
        priv, _ = jax.vmap(lambda p, t: jtfm.loss_fn(p, cfg, t, impl=impl))(
            sp, toks)
        ce_pub, fwd = jax.vmap(lambda p: jD._public_ce_and_logits(
            p, cfg, pub, None, True, impl=impl))(sp)
        K, B, S, V = fwd.shape
        kl = jmutual.mutual_kl_loss(fwd.reshape(K, B * S, V),
                                    part_mask=part_mask, impl=impl)
        w = 1.0 if part_mask is None else jnp.asarray(part_mask, jnp.float32)
        return (jnp.sum(priv * w) + jnp.sum(ce_pub * w) + jnp.sum(kl),
                (priv, ce_pub, kl))
    return total


@pytest.mark.parametrize("part", [None, [1.0, 0.0, 1.0]])
def test_dml_total_loss_and_client_grads_match_jax(small, part):
    """The fused round's loss, its per-client metrics and each client's
    gradient against JAX, whose Eq.-2 term runs the interpreted Pallas
    kernel with its custom VJP."""
    cfg, jparams, toks, pub = small
    (want, (priv, ce_pub, kl)), wg = jax.jit(jax.value_and_grad(
        _jax_dml_total(cfg, jnp.asarray(toks), jnp.asarray(pub), part,
                       "interpret"), has_aux=True))(jparams)
    tp = interop.params_from_numpy(_jax_numpy(jparams), device="cpu")
    got, m, grads = D.value_and_grad(
        D.dml_total_loss, tp, get_reduced("qwen3-4b"),
        torch.as_tensor(toks, dtype=torch.long),
        torch.as_tensor(pub, dtype=torch.long), part, impl="ref")
    _close(got, want)
    _close(m["private_loss"], priv)
    _close(m["public_ce"], ce_pub)
    _close(m["kld_avg"], kl, atol=1e-6, rtol=1e-5)
    _trees_close(grads, wg, atol=1e-5, rtol=1e-4)


def test_mutual_step_matches_jax(small):
    """One Eq.-1 step on the public batch (``make_mutual_step``) with a
    client sitting out, kl_weight 0.5 and T 1.3: metrics, the clip's norm
    and the updated params against JAX's."""
    cfg, jparams, _, pub = small
    opt = dict(lr=1e-3, warmup=1, total_steps=3)
    knobs = dict(kl_weight=0.5, temperature=1.3)
    part = np.asarray([1.0, 1.0, 0.0], np.float32)
    jstep = jax.jit(jD.make_mutual_step(cfg, JAdamWConfig(**opt), **knobs,
                                        impl="ref"))
    jp, _, jm = jstep(jparams, jD.stacked_adamw_init(jparams),
                      jnp.asarray(pub), part_mask=jnp.asarray(part))
    tp = interop.params_from_numpy(_jax_numpy(jparams), device="cpu")
    step = D.make_mutual_step(get_reduced("qwen3-4b"), AdamWConfig(**opt),
                              **knobs, impl="ref")
    tp, _, tm = step(tp, adamw_init(tp), torch.as_tensor(pub).long(),
                     part_mask=part)
    _close(tm["public_ce"], jm["public_ce"])
    _close(tm["kld_avg"], jm["kld_avg"], atol=1e-6, rtol=1e-5)
    _close(tm["grad_norm"], jm["grad_norm"], atol=1e-5, rtol=1e-5)
    _trees_close(tp, jp, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# (d) the Federation session, round by round

SESSIONS = {                    # name: (JAX kernel impl, participation, R)
    "ref": ("ref", 0, 3),
    "ref-partial": ("ref", 2, 3),
    "interpret": ("interpret", 0, 2),
    "ref-alone": ("ref", 1, 2),   # M < 2: the local step, no sharing
}


@pytest.fixture(scope="module")
def jax_sessions():
    """The JAX sessions (run once), with the params they started from."""
    out = {}
    for name, (impl, part, rounds) in SESSIONS.items():
        pop = JLMClients(jget_reduced("qwen3-4b"), n_clients=3,
                         rounds=rounds, batch=2, seq=16, seed=0,
                         kernel_impl=impl)
        start = _jax_numpy(pop.state_dict())
        fed = JFederation(pop, JDML(), participation=part)
        fed.run()
        out[name] = (start, fed)
    return out


def _port_session(start, rounds, part):
    pop = LMClients(get_reduced("qwen3-4b"), n_clients=3, rounds=rounds,
                    batch=2, seq=16, seed=0, device="cpu")
    pop.load_state_dict(interop.params_from_numpy(start, device="cpu"), {})
    fed = Federation(pop, DML(), participation=part)
    fed.run()
    return fed


@pytest.mark.parametrize("name", list(SESSIONS))
def test_federation_matches_jax_round_by_round(jax_sessions, name):
    """K=3 reduced qwen3-4b DML sessions from JAX-initialised params:
    participants, comm bytes, per-round private_loss, public_ce and
    kld_avg, and the final params and AdamW state."""
    _, part, rounds = SESSIONS[name]
    start, jfed = jax_sessions[name]
    fed = _port_session(start, rounds, part)
    assert len(fed.history.rounds) == len(jfed.history.rounds) == rounds
    for got, want in zip(fed.history.rounds, jfed.history.rounds):
        assert got.participants == want.participants
        assert got.comm_bytes == want.comm_bytes
        _close(got.client_loss, want.client_loss, atol=2e-5, rtol=0)
        _close(got.kl_loss, want.kl_loss, atol=2e-5, rtol=0)
        if want.public_ce is None:
            assert got.public_ce is None
        else:
            _close(got.public_ce, want.public_ce, atol=2e-5, rtol=0)
    assert fed.history.total_comm_bytes == jfed.history.total_comm_bytes
    _trees_close(fed.population.client_params,
                 jfed.population.client_params, atol=1e-4, rtol=0)
    assert int(fed.population.client_opts["step"]) == rounds


def test_absent_clients_keep_params_and_moments(jax_sessions):
    """Partial participation: the client that sat a round out has exactly
    its params and moments of before the round."""
    start, jfed = jax_sessions["ref-partial"]
    pop = LMClients(get_reduced("qwen3-4b"), n_clients=3, rounds=1, batch=2,
                    seq=16, seed=0, device="cpu")
    pop.load_state_dict(interop.params_from_numpy(start, device="cpu"), {})
    fed = Federation(pop, DML(), participation=2)
    before = tree_map(torch.clone, pop.state_dict())
    fed.run()
    (absent,) = [c for c in range(3) if c not in fed.history.rounds[0]
                 .participants]
    for key in ("client_params", "client_opts"):
        pairs = zip(tree_leaves(before[key]),
                    tree_leaves(pop.state_dict()[key]))
        for b, a in pairs:
            if b.dim():
                assert torch.equal(b[absent], a[absent])


# ---------------------------------------------------------------------------
# (e) checkpoints cross between the packages

def test_save_state_restores_across_packages(jax_sessions, tmp_path):
    """A JAX ``save_state`` restores into a port session, and a port
    ``save_state`` into a JAX session: the same params, moments, round
    counter and history."""
    start, jfed = jax_sessions["ref"]
    jfed.save_state(str(tmp_path / "from_jax"))
    pop = LMClients(get_reduced("qwen3-4b"), n_clients=3, rounds=3, batch=2,
                    seq=16, seed=1, device="cpu")
    fed = Federation(pop, DML())
    fed.restore_state(str(tmp_path / "from_jax"))
    _trees_close(pop.state_dict(), jfed.population.state_dict())
    assert fed.round == 3
    assert [r.kl_loss for r in fed.history.rounds] == \
        [r.kl_loss for r in jfed.history.rounds]

    fed = _port_session(start, 2, 0)
    fed.save_state(str(tmp_path / "from_torch"))
    jpop = JLMClients(jget_reduced("qwen3-4b"), n_clients=3, rounds=2,
                      batch=2, seq=16, seed=1, kernel_impl="ref")
    jf = JFederation(jpop, JDML())
    jf.restore_state(str(tmp_path / "from_torch"))
    _trees_close(fed.population.state_dict(), jpop.state_dict())
    assert jf.round == 2
    assert jf.history.total_comm_bytes == fed.history.total_comm_bytes


def test_session_helpers_match_jax():
    """The participation sampler, the comm accounting, the client-axis
    lerp, and the privacy strategies, which the stacked LM population
    refuses as the JAX one does."""
    for seed, r in ((0, 0), (3, 7), (9, 2)):
        assert sample_participants(5, 3, seed, r) == jsample(5, 3, seed, r)
    assert D.comm_bytes(get_reduced("qwen3-4b"), 3, 64) == \
        jD.comm_bytes(jget_reduced("qwen3-4b"), 3, 64)
    a, b = torch.randn(3, 4), torch.randn(3, 4)
    got = stacking.client_lerp({"x": a}, {"x": b}, [1.0, 0.0, 1.0])["x"]
    assert torch.equal(got[0], b[0]) and torch.equal(got[1], a[1])
    assert get_strategy("dp-dml", dp_noise_multiplier=1.0).name == "dp-dml"
    pop = LMClients(get_reduced("qwen3-4b"), n_clients=2, rounds=1, batch=2,
                    seq=8, device="cpu")

    class TrimmedLike:
        name = "trimmed-dml"
    with pytest.raises(ValueError, match="does not support strategy"):
        Federation(pop, TrimmedLike())
    with pytest.raises(ValueError, match="mutual_epochs"):
        Federation(pop, DML(mutual_epochs=2))
    h = Federation(pop, DML()).evaluate()
    assert len(h.client_eval_loss) == 2
    assert all(np.isfinite(h.client_eval_loss))


# ---------------------------------------------------------------------------
# (f) the CLI

def test_train_cli_runs_two_steps_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--method", "dml",
         "--clients", "3", "--steps", "2", "--batch", "2", "--seq", "16",
         "--device", "cpu", "--save", str(tmp_path / "ck")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert any(l.startswith("step    1 loss=") for l in lines), proc.stdout
    assert (tmp_path / "ck.npz").exists() and (tmp_path / "ck.json").exists()
