"""Pair-weighted mutual-learning KL (the paper's Eq. 2 at vocabulary
scale): hand-written CUDA kernels for Hopper behind a
``torch.autograd.Function``.

The forward entry point replaces the TPU kernel
``repro/kernels/kl_mutual.py:68`` (``_kl_pair_kernel`` behind
``_kl_pair_forward``), the backward entry point the plain-JAX
``_streaming_pair_bwd`` of its custom VJP (:178-256).  ``kl_mutual``
serves the square forward-only TPU kernel ``kl_mutual.py:32``
(``_kl_kernel``) through the same forward, by the identity
``mutual_kl(x) == mutual_kl_pair(x, x, (1 - I) / (K - 1))``
(``repro/kernels/ref.py:137``).  The source is ``csrc/kl_mutual_pair.cu``;
its header says what bounds it on the H100.

On CUDA tensors the wrappers launch the kernels or raise; on CPU tensors
they run the plain versions ``ref.mutual_kl_pair`` / ``ref.mutual_kl``,
and autograd gives the gradient.  The forward also writes the live and
fixed logsumexps, which the backward reads instead of recomputing them.
The fixed side's gradient is computed only when autograd asks for it;
``pair_w`` is data (masks and averaging constants) and gets none.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_CLIENTS = 8

# kernel launches in this process, one per call of each entry point
launches = 0             # kl_mutual_pair forward
bwd_launches = 0         # kl_mutual_pair backward
mutual_kl_launches = 0   # kl_mutual (the square case, through the forward)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("kl_mutual_pair")
    lib.kl_mutual_pair_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.kl_mutual_pair_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.kl_mutual_pair_fwd.restype = ctypes.c_int
    lib.kl_mutual_pair_bwd.restype = ctypes.c_int
    return lib


def _check(live, fixed, pair_w) -> None:
    if live.dim() != 3 or fixed.dim() != 3 \
            or live.shape[1:] != fixed.shape[1:]:
        raise ValueError(f"want live (Kl,B,V) and fixed (Kg,B,V); got "
                         f"{tuple(live.shape)}, {tuple(fixed.shape)}")
    Kl, B, V = live.shape
    Kg = fixed.shape[0]
    if tuple(pair_w.shape) != (Kl, Kg):
        raise ValueError(f"pair_w {tuple(pair_w.shape)} is not (Kl, Kg) = "
                         f"{(Kl, Kg)}")
    if not (1 <= Kl <= MAX_CLIENTS and 1 <= Kg <= MAX_CLIENTS):
        raise ValueError(f"the kernel takes 1..{MAX_CLIENTS} clients a "
                         f"side, got Kl={Kl}, Kg={Kg}")
    if B == 0 or V == 0:
        raise ValueError("empty batch or vocabulary")
    if live.dtype not in DTYPES or fixed.dtype != live.dtype:
        raise ValueError(f"want live and fixed of one dtype in {DTYPES}; "
                         f"got {live.dtype}, {fixed.dtype}")
    if not (live.device == fixed.device == pair_w.device):
        raise ValueError("live, fixed and pair_w on different devices")
    if live.stride(-1) != 1 or fixed.stride(-1) != 1:
        raise ValueError("the vocabulary axis must have unit stride")
    if B >= 2 ** 16 or V >= 2 ** 31:
        raise ValueError(f"shape {tuple(live.shape)} exceeds the launch "
                         "grid (B < 65536, V < 2**31)")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(live, fixed, w, temperature: float):
    """Launches the forward; returns (out (Kl,B), lse_live (Kl,B),
    lse_fixed (Kg,B)), fp32."""
    Kl, B, V = live.shape
    Kg = fixed.shape[0]
    with torch.cuda.device(live.device):
        out = torch.empty((Kl, B), dtype=torch.float32, device=live.device)
        lse_live = torch.empty_like(out)
        lse_fixed = torch.empty((Kg, B), dtype=torch.float32,
                                device=live.device)
        rc = _lib().kl_mutual_pair_fwd(
            live.data_ptr(), fixed.data_ptr(), w.data_ptr(), out.data_ptr(),
            lse_live.data_ptr(), lse_fixed.data_ptr(), live.stride(0),
            live.stride(1), fixed.stride(0), fixed.stride(1), Kl, Kg, B, V,
            1.0 / temperature, int(live.dtype == torch.bfloat16),
            _stream(live))
    if rc != 0:
        raise RuntimeError(f"kl_mutual_pair_fwd launch failed with CUDA "
                           f"error {rc}")
    return out, lse_live, lse_fixed


def _backward(live, fixed, w, out, lse_live, lse_fixed, g_bar,
              temperature: float, want_fixed: bool):
    """Launches the backward; returns (dlive, dfixed or None) in the input
    dtype."""
    Kl, B, V = live.shape
    Kg = fixed.shape[0]
    g_bar = g_bar.float().contiguous()
    with torch.cuda.device(live.device):
        dlive = torch.empty((Kl, B, V), dtype=live.dtype, device=live.device)
        dfixed = (torch.empty((Kg, B, V), dtype=fixed.dtype,
                              device=live.device) if want_fixed else None)
        rc = _lib().kl_mutual_pair_bwd(
            live.data_ptr(), fixed.data_ptr(), w.data_ptr(), out.data_ptr(),
            g_bar.data_ptr(), lse_live.data_ptr(), lse_fixed.data_ptr(),
            dlive.data_ptr(), None if dfixed is None else dfixed.data_ptr(),
            live.stride(0), live.stride(1), fixed.stride(0), fixed.stride(1),
            Kl, Kg, B, V, 1.0 / temperature,
            int(live.dtype == torch.bfloat16), _stream(live))
    if rc != 0:
        raise RuntimeError(f"kl_mutual_pair_bwd launch failed with CUDA "
                           f"error {rc}")
    return dlive, dfixed


class _KlMutualPair(torch.autograd.Function):

    @staticmethod
    def forward(ctx, live, fixed, w, temperature):
        global launches
        out, lse_live, lse_fixed = _forward(live, fixed, w, temperature)
        launches += 1
        ctx.save_for_backward(live, fixed, w, out, lse_live, lse_fixed)
        ctx.temperature = temperature
        return out

    @staticmethod
    def backward(ctx, g_bar):
        global bwd_launches
        dlive, dfixed = _backward(*ctx.saved_tensors, g_bar,
                                  ctx.temperature, ctx.needs_input_grad[1])
        bwd_launches += 1
        return dlive, dfixed, None, None


def kl_mutual_pair(live, fixed, pair_w, *, temperature: float = 1.0):
    """Differentiable pair-weighted Eq. 2: live (Kl, B, V) x fixed
    (Kg, B, V) with (Kl, Kg) weights -> (Kl, B) fp32.  Pass
    ``fixed = live.detach()`` (or received predictions) for the federated
    gradient semantics; the fixed side's gradient is then never computed.
    """
    if all(t.device.type == "cpu" for t in (live, fixed, pair_w)):
        return ref.mutual_kl_pair(live, fixed, pair_w,
                                  temperature=temperature)
    _check(live, fixed, pair_w)
    if live.device.type != "cuda":
        raise ValueError(f"kl_mutual_pair runs on CUDA or CPU tensors, not "
                         f"{live.device}")
    w = pair_w.detach().to(dtype=torch.float32).contiguous()
    return _KlMutualPair.apply(live, fixed, w, float(temperature))


def kl_mutual(logits, *, temperature: float = 1.0):
    """Forward-only Eq. 2, logits (K, B, V) -> (K, B) fp32 average pairwise
    KL, through the pair forward with w = (1 - I) / (K - 1)."""
    global mutual_kl_launches
    if logits.device.type == "cpu":
        return ref.mutual_kl(logits, temperature=temperature)
    K = logits.shape[0]
    w = (1.0 - torch.eye(K, device=logits.device)) / max(K - 1, 1)
    _check(logits, logits, w)
    if logits.device.type != "cuda":
        raise ValueError(f"kl_mutual runs on CUDA or CPU tensors, not "
                         f"{logits.device}")
    out, _, _ = _forward(logits.detach(), logits.detach(), w,
                         float(temperature))
    mutual_kl_launches += 1
    return out
