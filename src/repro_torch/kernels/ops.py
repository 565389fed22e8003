"""Kernel entry points and the policy of where the port runs.

impl values:
  - "ref":  the plain PyTorch version (``kernels/ref.py``); runs anywhere.
  - "cuda": the hand-written CUDA kernels; CUDA tensors only.

There is no ambient default: an entry point (an engine, a CLI) resolves
its impl ONCE from its device with ``resolve_impl`` and passes it down as a
plain argument to every call that can reach a kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import kl_mutual, ref, sparse_kl, ssd_scan
from repro_torch.kernels.flash_attention import flash_attention

IMPLS = ("ref", "cuda")


def _check_impl(impl: str) -> str:
    """An impl string outside ``IMPLS`` is a config bug, never a fallback."""
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one "
                         f"of {IMPLS}")
    return impl


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card: ``None`` means CUDA, and raises when
    there is none.  Only an explicit ``device="cpu"`` runs on the CPU, and
    ``device="meta"`` builds shapes without storage (the dry-run)."""
    device = torch.device("cuda" if device is None else device)
    if device.type in ("cpu", "meta"):
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device}: pass "
                           "device='cpu' to run on the CPU")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_impl(impl: Optional[str], device) -> str:
    """Resolve the kernel impl once for an entry point on ``device``:
    ``None`` gives "cuda" on a CUDA device and "ref" on the CPU.  Asking
    for "cuda" on the CPU raises."""
    device = torch.device(device)
    if impl is None:
        return "cuda" if device.type == "cuda" else "ref"
    _check_impl(impl)
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl 'cuda' needs a CUDA device, got {device}")
    return impl


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              positions_q=None, positions_k=None,
              impl: Optional[str] = None):
    """(B, S, H, hd)-layout attention: the flash kernel or the plain version.

    Explicit positions (the decode/cache path) always take the plain
    version, as ``repro/kernels/ops.py:100-103`` does, and need no impl.
    Self-attention (training, prefill and prompt scoring) runs the caller's
    ``impl``, which it must give.  Differentiable on every impl: "cuda"
    runs the CUDA backward, "ref" gets its gradient from autograd.
    """
    if impl is not None:
        _check_impl(impl)
    if positions_q is not None or positions_k is not None:
        return ref.attention(q, k, v, causal=causal, window=window,
                             positions_q=positions_q, positions_k=positions_k)
    if impl is None:
        raise ValueError("self-attention needs an explicit impl; resolve "
                         "one with resolve_impl")
    if impl == "ref":
        return ref.attention(q, k, v, causal=causal, window=window)
    if not q.is_cuda:
        raise ValueError("impl 'cuda' needs CUDA tensors, got "
                         f"{q.device}")
    return flash_attention(q, k, v, causal=causal, window=window)[0]


def mutual_kl(logits, *, temperature: float = 1.0, impl: str):
    """(K, B, V) -> (K, B) average pairwise KL (paper Eq. 2), forward
    only: the sharing/eval readout."""
    _check_impl(impl)
    if impl == "ref":
        return ref.mutual_kl(logits, temperature=temperature)
    if not logits.is_cuda:
        raise ValueError("impl 'cuda' needs CUDA tensors, got "
                         f"{logits.device}")
    return kl_mutual.kl_mutual(logits, temperature=temperature)


def mutual_kl_pair(live, fixed, pair_w, *, temperature: float = 1.0,
                   impl: str):
    """Pair-weighted rectangular Eq. 2: (Kl, B, V) live x (Kg, B, V) fixed
    with (Kl, Kg) weights -> (Kl, B).  Differentiable on every impl: the
    Eq.-2 training hot path (``core.mutual.mutual_kl_terms`` routes
    here)."""
    _check_impl(impl)
    if impl == "ref":
        return ref.mutual_kl_pair(live, fixed, pair_w,
                                  temperature=temperature)
    if not live.is_cuda:
        raise ValueError("impl 'cuda' needs CUDA tensors, got "
                         f"{live.device}")
    return kl_mutual.kl_mutual_pair(live, fixed, pair_w,
                                    temperature=temperature)


def sparse_mutual_kl(live, idx, logp_top, pair_w, *,
                     temperature: float = 1.0, impl: str):
    """Pair-weighted Eq. 2 against RECEIVED sparse (top-k) predictions:
    live (Kl, B, V) x idx/logp_top (J, B, k) with (Kl, J) weights ->
    (Kl, B).  Differentiable on the live side at every impl: "cuda" runs
    the sparse-KL kernel and its backward, "ref" the plain version under
    autograd.  The SparseDML hot path (``core.mutual.sparse_mutual_kl_loss``
    and ``sparse_kl_to_received`` route here)."""
    _check_impl(impl)
    if impl == "ref":
        return ref.sparse_kl_pair(live, idx, logp_top, pair_w,
                                  temperature=temperature)
    if not live.is_cuda:
        raise ValueError("impl 'cuda' needs CUDA tensors, got "
                         f"{live.device}")
    return sparse_kl.sparse_kl_topk(live, idx, logp_top, pair_w,
                                    temperature=temperature)


def ssd(x, dt, A, B_mat, C_mat, *, chunk: int = 256, initial_state=None,
        impl: Optional[str] = None):
    """Mamba2 SSD chunked scan -> (y, final_state): the CUDA kernels or
    the plain version, as the caller's ``impl`` says.

    The CUDA kernels start from the zero state, so a continuation from
    ``initial_state`` runs only at impl "ref" and "cuda" refuses it (the
    JAX package sends it to the plain version on every impl).
    Differentiable on every impl: "cuda" runs the CUDA backward, "ref"
    gets its gradient from autograd.
    """
    if impl is None:
        raise ValueError("the SSD scan needs an explicit impl; resolve one "
                         "with resolve_impl")
    _check_impl(impl)
    if impl == "ref":
        return ref.ssd(x, dt, A, B_mat, C_mat, chunk=chunk,
                       initial_state=initial_state)
    if initial_state is not None:
        raise ValueError("the CUDA SSD kernels start from the zero state; "
                         "a continuation from initial_state runs at impl "
                         "'ref'")
    if not x.is_cuda:
        raise ValueError(f"impl 'cuda' needs CUDA tensors, got {x.device}")
    return ssd_scan.ssd_scan(x, dt, A, B_mat, C_mat, chunk=chunk)
