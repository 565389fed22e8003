"""Pair-weighted Eq. 2 against received sparse (top-k) predictions -- the
SparseDML hot path: hand-written CUDA kernels for Hopper behind a
``torch.autograd.Function``.

The forward entry point replaces the TPU kernel
``repro/kernels/sparse_kl.py:47`` (``_sparse_kl_kernel`` behind
``_sparse_kl_forward``), the backward entry point the plain-JAX
``_streaming_sparse_bwd`` of its custom VJP (:167-253).  The source is
``csrc/sparse_kl.cu``; its header says what bounds it on the H100 and what
the design does about it.

``sparse_kl_topk`` has the contract of the JAX ``sparse_kl_topk`` (:256):
live (Kl, B, V) against J received top-k sets idx (J, B, k) int32 and
logp (J, B, k) fp32 with (Kl, J) pair weights -> (Kl, B) fp32.  On CUDA
tensors it launches the kernels or raises: live fp32 or bf16 with unit
stride along V, any J >= 1 and 1 <= k <= V.  The forward also writes the
per-row Z, -H and C1 (``stats``), which the backward reads instead of
recomputing them.  Only the live side gets a gradient: the received sets
and the weights are data that crossed the client boundary.  On CPU tensors
it runs the plain version ``ref.sparse_kl_pair``, and autograd gives its
gradient.

One launch takes at most ``MAX_SENDERS`` senders and, with more than one
sender, at most ``MAX_ENTRIES`` received entries (J * k: the backward's
table of them in shared memory).  More are cut into sender blocks
(``sender_blocks``): the loss and the live gradient are sums over the
senders, so each block is one forward and one backward launch with its own
C1, and the blocks' losses and gradients add up.  A single sender whose k
alone exceeds the table is one block, and its backward reads the entries
from the received tensors in device memory instead of shared memory.
"""
from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_SENDERS = 64            # one launch's senders (the backward's c_j table)
MAX_ENTRIES = 4096          # J * k: the backward's shared-memory table

# kernel launches in this process, one per call of each entry point;
# chip_smoke.py reads them to show that a path went through the kernels
launches = 0
bwd_launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("sparse_kl")
    lib.sparse_kl_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.sparse_kl_bwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.sparse_kl_fwd.restype = ctypes.c_int
    lib.sparse_kl_bwd.restype = ctypes.c_int
    return lib


def _check(live, idx, logp, pair_w) -> None:
    """What the kernels take."""
    if live.dim() != 3 or idx.dim() != 3 or idx.shape != logp.shape \
            or idx.shape[1] != live.shape[1]:
        raise ValueError(f"want live (Kl,B,V) and idx/logp (J,B,k); got "
                         f"{tuple(live.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(logp.shape)}")
    Kl, B, V = live.shape
    J, _, k = idx.shape
    if tuple(pair_w.shape) != (Kl, J):
        raise ValueError(f"pair_w {tuple(pair_w.shape)} is not (Kl, J) = "
                         f"{(Kl, J)}")
    if B == 0 or V == 0 or Kl == 0 or k == 0:
        raise ValueError("empty clients, batch, vocabulary or top-k set")
    if J == 0:
        raise ValueError("no senders")
    if k > V:
        raise ValueError(f"k={k} exceeds the vocabulary V={V}")
    if live.dtype not in DTYPES or idx.dtype != torch.int32 \
            or logp.dtype != torch.float32:
        raise ValueError(f"want live in {DTYPES}, idx int32 and logp fp32; "
                         f"got {live.dtype}, {idx.dtype}, {logp.dtype}")
    if not (live.device == idx.device == logp.device == pair_w.device):
        raise ValueError("live, idx, logp and pair_w on different devices")
    if live.stride(-1) != 1:
        raise ValueError("the vocabulary axis must have unit stride")
    if B >= 2 ** 31 or V >= 2 ** 31 or Kl >= 2 ** 16:
        raise ValueError(f"shape {tuple(live.shape)} exceeds the launch "
                         "grid (Kl < 65536, B and V < 2**31)")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(live, idx, logp, w, temperature: float):
    """Launches the forward; returns (out (Kl, B), stats (3, Kl, B) = Z,
    -H, C1), fp32.  idx, logp and w must be contiguous."""
    Kl, B, V = live.shape
    J, _, k = idx.shape
    with torch.cuda.device(live.device):
        out = torch.empty((Kl, B), dtype=torch.float32, device=live.device)
        stats = torch.empty((3, Kl, B), dtype=torch.float32,
                            device=live.device)
        rc = _lib().sparse_kl_fwd(
            live.data_ptr(), idx.data_ptr(), logp.data_ptr(), w.data_ptr(),
            out.data_ptr(), stats.data_ptr(), live.stride(0),
            live.stride(1), Kl, J, B, V, k, 1.0 / temperature,
            int(live.dtype == torch.bfloat16), _stream(live))
    if rc != 0:
        raise RuntimeError(f"sparse_kl_fwd launch failed with CUDA error "
                           f"{rc}")
    return out, stats


def _backward(live, idx, logp, w, stats, g_bar, temperature: float):
    """Launches the backward; returns dlive (Kl, B, V) in live's dtype."""
    Kl, B, V = live.shape
    J, _, k = idx.shape
    g_bar = g_bar.float().contiguous()
    with torch.cuda.device(live.device):
        dlive = torch.empty((Kl, B, V), dtype=live.dtype, device=live.device)
        rc = _lib().sparse_kl_bwd(
            live.data_ptr(), idx.data_ptr(), logp.data_ptr(), w.data_ptr(),
            stats.data_ptr(), g_bar.data_ptr(), dlive.data_ptr(),
            live.stride(0), live.stride(1), Kl, J, B, V, k,
            1.0 / temperature, int(live.dtype == torch.bfloat16),
            _stream(live))
    if rc != 0:
        raise RuntimeError(f"sparse_kl_bwd launch failed with CUDA error "
                           f"{rc}")
    return dlive


def sender_blocks(J: int, k: int) -> list:
    """Consecutive slices of the J senders that one launch each takes: at
    most MAX_SENDERS senders and MAX_ENTRIES entries, or one sender."""
    size = max(1, min(MAX_SENDERS, MAX_ENTRIES // k))
    return [slice(j, min(j + size, J)) for j in range(0, J, size)]


def blocked_senders(fn, live, idx, logp_top, pair_w):
    """``fn(live, idx[S], logp_top[S], pair_w[:, S]) -> (Kl, B)`` summed over
    the sender blocks S; with one block ``fn`` sees the whole tensors."""
    blocks = sender_blocks(idx.shape[0], idx.shape[2])
    if len(blocks) == 1:
        return fn(live, idx, logp_top, pair_w)
    total = None
    for S in blocks:
        part = fn(live, idx[S], logp_top[S], pair_w[:, S])
        total = part if total is None else total + part
    return total


class _SparseKl(torch.autograd.Function):
    """One sender block: its forward and backward launches.  ``count``
    marks the block whose launches the counters record, one per call of
    the entry point in each direction."""

    @staticmethod
    def forward(ctx, live, idx, logp, w, temperature, count):
        global launches
        out, stats = _forward(live, idx, logp, w, temperature)
        launches += count
        ctx.save_for_backward(live, idx, logp, w, stats)
        ctx.temperature, ctx.count = temperature, count
        return out

    @staticmethod
    def backward(ctx, g_bar):
        global bwd_launches
        dlive = _backward(*ctx.saved_tensors, g_bar, ctx.temperature)
        bwd_launches += ctx.count
        return dlive, None, None, None, None, None


def sparse_kl_topk(live, idx, logp_top, pair_w, *,
                   temperature: float = 1.0):
    """Differentiable pair-weighted sparse KL: live (Kl, B, V) x received
    top-k sets idx/logp_top (J, B, k) with (Kl, J) weights -> (Kl, B) fp32.
    The gradient reaches the live side only."""
    if all(t.device.type == "cpu" for t in (live, idx, logp_top, pair_w)):
        return ref.sparse_kl_pair(live, idx, logp_top, pair_w,
                                  temperature=temperature)
    _check(live, idx, logp_top, pair_w)
    if live.device.type != "cuda":
        raise ValueError(f"sparse_kl_topk runs on CUDA or CPU tensors, not "
                         f"{live.device}")
    w = pair_w.detach().to(dtype=torch.float32)
    order = itertools.count()          # the first sender block counts
    return blocked_senders(
        lambda a, i, lp, wb: _SparseKl.apply(
            a, i.detach().contiguous(), lp.detach().contiguous(),
            wb.contiguous(), float(temperature), int(next(order) == 0)),
        live, idx, logp_top, w)
