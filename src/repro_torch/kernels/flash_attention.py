"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper behind one ``torch.autograd.Function``.

The forward replaces the TPU kernel ``repro/kernels/flash_attention.py:34``
(``_attn_kernel`` behind ``_flash_forward``), the backward the plain-JAX
``_streaming_attn_bwd`` of its custom VJP (:145-206).  The kernel sources
are ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``;
their headers say what bounds them on the H100 and what the design does
about it.  They are built with ``nvcc`` at first use (``_build``) and
called through ctypes.

``flash_attention`` takes the port's (B, S, H, hd) layout with strides, so
q/k/v may be slices of the fused QKV projection, and returns
``(out (B, S, Hq, hd), lse (B, Hq, S) fp32)``.  On CUDA tensors it launches
the kernels or raises; the forward saves (q, k, v, out, lse) and the
backward launches the backward kernel for dq, dk, dv.  On CPU tensors it
runs the plain version ``ref.attention_lse``, and autograd gives its
gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

# kernel launches in this process, one per call of each entry point;
# chip_smoke.py reads them to show that a path went through the kernels
launches = 0
bwd_launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The forward's C entry point, built at first use, with its signature."""
    fn = _build.load("flash_attention_fwd").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 9
                   + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    """The backward's C entry point, built at first use."""
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 9
                   + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, dout=None) -> None:
    """What the kernels take; ``dout``, when given, is the backward's
    incoming gradient of out (B, S, Hq, hd)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,Hq,hd) and k, v (B,T,Hkv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[2]}")
    if S == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"want q, k, v all of one dtype in {DTYPES}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("head_dim must have unit stride")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if max(S, k.shape[1]) >= 2 ** 31 or B >= 2 ** 16:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch grid "
                         "(B < 65536, S < 2**31)")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernels copy 16-byte rows (TMA, cp.async)
        for name, t in (("q", q), ("k", k), ("v", v)):
            strides = [st for n, st in zip(t.shape[:3], t.stride()[:3])
                       if n > 1]
            if t.data_ptr() % 16 or any(st % 8 for st in strides):
                raise ValueError(
                    f"bf16 {name} must start on a 16-byte boundary and have "
                    f"batch, sequence and head strides of whole 16 bytes; "
                    f"got address offset {t.data_ptr() % 16}, strides "
                    f"{t.stride()}")
    if dout is not None and (dout.shape != q.shape or dout.dtype != q.dtype
                             or dout.device != q.device):
        raise ValueError(f"gradient of out {tuple(dout.shape)} "
                         f"{dout.dtype} on {dout.device} does not match q "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}")


def _forward(q, k, v, causal: bool, window: Optional[int]):
    """Launches the forward kernel; returns (out, lse)."""
    global launches
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    fn = _kernel()
    with torch.cuda.device(q.device):
        out = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], B, S, T, Hq, Hkv, hd, int(bool(causal)),
                0 if window is None else int(window), hd ** -0.5,
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with CUDA "
                           f"error {rc}")
    launches += 1
    return out, lse


def _backward(q, k, v, out, lse, dout, causal: bool,
              window: Optional[int]):
    """Launches the backward kernel; returns (dq, dk, dv) in the input
    dtype, contiguous."""
    global bwd_launches
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    dout = dout.contiguous()
    if dout.data_ptr() % 16:           # an offset view: the kernels copy
        dout = dout.clone()            # 16-byte rows
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
        dq = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device)
        dk = torch.empty((B, T, Hkv, hd), dtype=k.dtype, device=q.device)
        dv = torch.empty((B, T, Hkv, hd), dtype=v.dtype, device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                B, S, T, Hq, Hkv, hd, int(bool(causal)),
                0 if window is None else int(window), hd ** -0.5,
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed with CUDA "
                           f"error {rc}")
    bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The CUDA forward, saving (q, k, v, out, lse) for the CUDA backward.
    lse is an output but not differentiable (the JAX custom VJP
    differentiates out only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        _check(q, k, v, ctx.window, dout)
        dq, dk, dv = _backward(q, k, v, out, lse, dout, ctx.causal,
                               ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd).

    Returns (out (B, S, Hq, hd) in q.dtype, lse (B, Hq, S) fp32) with
    lse = m + log(max(l, 1e-30)); differentiable in q, k, v.  CPU tensors
    take ``ref.attention_lse``.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return ref.attention_lse(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 None if window is None else int(window))
