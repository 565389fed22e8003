"""Flash-attention forward: a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:34``
(``_attn_kernel`` behind ``_flash_forward``).  The kernel source is
``csrc/flash_attention_fwd.cu``; its header says what bounds it on the H100
and what the design does about it.  It is built with ``nvcc`` at first use
(``_build``) and called through ctypes.

``flash_attention`` takes the port's (B, S, H, hd) layout with strides, so
q/k/v may be slices of the fused QKV projection, and returns
``(out (B, S, Hq, hd), lse (B, Hq, S) fp32)``.  On CUDA tensors it launches
the kernel or raises; on CPU tensors it runs the plain version
``ref.attention_lse``.  The backward (and with it the
``torch.autograd.Function``) comes with the training slice, so inputs that
require grad are refused.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

# kernel launches in this process; chip_smoke.py reads it to show that the
# serving path went through the kernel
launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built at first use, with its signature."""
    fn = _build.load("flash_attention_fwd").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 9
                   + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window) -> None:
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
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("the CUDA flash-attention forward has no backward "
                         "yet; it takes no inputs that require grad")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if max(S, k.shape[1]) >= 2 ** 31 or B >= 2 ** 16:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch grid "
                         "(B < 65536, S < 2**31)")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd).

    Returns (out (B, S, Hq, hd) in q.dtype, lse (B, Hq, S) fp32) with
    lse = m + log(max(l, 1e-30)).  CPU tensors take ``ref.attention_lse``.
    """
    global launches
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return ref.attention_lse(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
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
