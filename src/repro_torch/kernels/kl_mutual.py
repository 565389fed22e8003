"""Pair-weighted mutual-learning KL (the paper's Eq. 2 at vocabulary
scale): hand-written CUDA kernels for Hopper behind a
``torch.autograd.Function``.

The pair forward replaces the TPU kernel ``repro/kernels/kl_mutual.py:68``
(``_kl_pair_kernel`` behind ``_kl_pair_forward``), the backward entry point
the plain-JAX ``_streaming_pair_bwd`` of its custom VJP (:178-256).  The
square forward replaces the forward-only TPU kernel ``kl_mutual.py:32``
(``_kl_kernel``): Eq. 2 of ONE tensor against itself, read once; the
square backward is ``_streaming_pair_bwd`` with fixed = live, reading it
once too.  Forward and backward launch the square kernels whenever
``fixed`` is ``live``'s storage viewed alike (``same_tensor``):
``kl_mutual`` (w = (1 - I) / (K - 1)), the DML round's
``kl_mutual_pair(x, x.detach(), mask)``, and the diagonal blocks of
``blocked_pair``; other pairs go to the pair kernels.  The source is
``csrc/kl_mutual_pair.cu``; its header says what bounds it on the H100.

On CUDA tensors the wrappers launch the kernels or raise; on CPU tensors
they run the plain versions ``ref.mutual_kl_pair`` / ``ref.mutual_kl``,
and autograd gives the gradient.  The forward also writes the live and
fixed logsumexps (one tensor for both after the square kernel), which the
backward reads instead of recomputing them.  The fixed side's gradient is
computed only when autograd asks for it; ``pair_w`` is data (masks and
averaging constants) and gets none.

The kernels keep each client's streaming state in registers, so one launch
takes at most ``MAX_CLIENTS`` clients a side.  More clients are cut into
blocks of at most that many on each side (``blocked_pair``): the loss of a
live row is a sum over the fixed clients, so it is the sum of the fixed
blocks' losses, and live rows are independent.  Each (live, fixed) block
pair is one forward and one backward launch with its own saved partial
loss and logsumexps; autograd sums a live block's gradient over the fixed
blocks and a fixed block's over the live blocks.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_CLIENTS = 8

SQUARE, PAIR = "kl_mutual_square_fwd", "kl_mutual_pair_fwd"
SQUARE_BWD, PAIR_BWD = "kl_mutual_square_bwd", "kl_mutual_pair_bwd"

# kernel launches in this process, one per call of each entry point
launches = 0             # kl_mutual_pair forward
bwd_launches = 0         # kl_mutual_pair backward
mutual_kl_launches = 0   # kl_mutual
# ... and by kernel: calls of an entry point that launched it
square_launches = 0      # SQUARE (fixed is live)
pair_launches = 0        # PAIR
square_bwd_launches = 0  # SQUARE_BWD (fixed is live)
pair_bwd_launches = 0    # PAIR_BWD


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("kl_mutual_pair")
    lib.kl_mutual_pair_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.kl_mutual_pair_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.kl_mutual_square_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.kl_mutual_square_bwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    for name in (SQUARE, PAIR, SQUARE_BWD, PAIR_BWD):
        getattr(lib, name).restype = ctypes.c_int
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
    if Kl == 0 or Kg == 0:
        raise ValueError(f"no clients: Kl={Kl}, Kg={Kg}")
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


def same_tensor(a, b) -> bool:
    """Whether ``a`` and ``b`` view one storage alike (data pointer, shape,
    strides, dtype and device): then the forward is the square case."""
    return (a.device == b.device and a.dtype == b.dtype
            and a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def _forward(live, fixed, w, temperature: float):
    """Launches the square forward when ``same_tensor(live, fixed)``, else
    the pair forward; returns (out (Kl,B), lse_live (Kl,B), lse_fixed
    (Kg,B), the kernel's name), the first three fp32 (after the square
    kernel lse_fixed is lse_live)."""
    Kl, B, V = live.shape
    Kg = fixed.shape[0]
    bf16 = int(live.dtype == torch.bfloat16)
    with torch.cuda.device(live.device):
        out = torch.empty((Kl, B), dtype=torch.float32, device=live.device)
        lse_live = torch.empty_like(out)
        if same_tensor(live, fixed):
            lse_fixed, name = lse_live, SQUARE
            rc = _lib().kl_mutual_square_fwd(
                live.data_ptr(), w.data_ptr(), out.data_ptr(),
                lse_live.data_ptr(), live.stride(0), live.stride(1), Kl, B,
                V, 1.0 / temperature, bf16, _stream(live))
        else:
            lse_fixed, name = torch.empty(
                (Kg, B), dtype=torch.float32, device=live.device), PAIR
            rc = _lib().kl_mutual_pair_fwd(
                live.data_ptr(), fixed.data_ptr(), w.data_ptr(),
                out.data_ptr(), lse_live.data_ptr(), lse_fixed.data_ptr(),
                live.stride(0), live.stride(1), fixed.stride(0),
                fixed.stride(1), Kl, Kg, B, V, 1.0 / temperature, bf16,
                _stream(live))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    return out, lse_live, lse_fixed, name


def _backward(live, fixed, w, out, lse_live, lse_fixed, g_bar,
              temperature: float, want_fixed: bool):
    """Launches the square backward when ``same_tensor(live, fixed)`` (it
    reads the one lse of the square forward), else the pair backward;
    returns (dlive, dfixed or None, the kernel's name), the gradients in
    the input dtype."""
    Kl, B, V = live.shape
    Kg = fixed.shape[0]
    g_bar = g_bar.float().contiguous()
    bf16 = int(live.dtype == torch.bfloat16)
    with torch.cuda.device(live.device):
        dlive = torch.empty((Kl, B, V), dtype=live.dtype, device=live.device)
        dfixed = (torch.empty((Kg, B, V), dtype=fixed.dtype,
                              device=live.device) if want_fixed else None)
        dfixed_ptr = None if dfixed is None else dfixed.data_ptr()
        if same_tensor(live, fixed):
            name = SQUARE_BWD
            rc = _lib().kl_mutual_square_bwd(
                live.data_ptr(), w.data_ptr(), out.data_ptr(),
                g_bar.data_ptr(), lse_live.data_ptr(), dlive.data_ptr(),
                dfixed_ptr, live.stride(0), live.stride(1), Kl, B, V,
                1.0 / temperature, bf16, _stream(live))
        else:
            name = PAIR_BWD
            rc = _lib().kl_mutual_pair_bwd(
                live.data_ptr(), fixed.data_ptr(), w.data_ptr(),
                out.data_ptr(), g_bar.data_ptr(), lse_live.data_ptr(),
                lse_fixed.data_ptr(), dlive.data_ptr(), dfixed_ptr,
                live.stride(0), live.stride(1), fixed.stride(0),
                fixed.stride(1), Kl, Kg, B, V, 1.0 / temperature, bf16,
                _stream(live))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    return dlive, dfixed, name


def client_blocks(n: int, size: int = MAX_CLIENTS) -> list:
    """Consecutive slices of at most ``size`` of ``range(n)``."""
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def blocked_pair(fn, live, fixed, pair_w, size: int = MAX_CLIENTS):
    """Eq. 2 over client blocks of at most ``size`` a side:
    ``fn(live[L], fixed[F], pair_w[L, F]) -> (len(L), B)`` summed over the
    fixed blocks F and stacked over the live blocks L.  With one block a
    side ``fn`` sees the whole tensors (no slicing)."""
    Kl, Kg = live.shape[0], fixed.shape[0]
    if Kl <= size and Kg <= size:
        return fn(live, fixed, pair_w)
    rows = []
    for L in client_blocks(Kl, size):
        total = None
        for F in client_blocks(Kg, size):
            part = fn(live[L], fixed[F], pair_w[L, F])
            total = part if total is None else total + part
        rows.append(total)
    return torch.cat(rows)


def _count(name: str, seen: set) -> None:
    """Counts the kernel ``name`` once for each call of an entry point
    whose block pairs launched it (``seen``: the call's kernels counted so
    far)."""
    global square_launches, pair_launches
    global square_bwd_launches, pair_bwd_launches
    if name in seen:
        return
    seen.add(name)
    square_launches += name == SQUARE
    pair_launches += name == PAIR
    square_bwd_launches += name == SQUARE_BWD
    pair_bwd_launches += name == PAIR_BWD


class _KlMutualPair(torch.autograd.Function):
    """One (live, fixed) block pair: its forward and backward launches.
    ``count`` marks the block whose launches the entry-call counters
    record, one per call of the entry point in each direction; each
    direction counts the kernel it launched by name (``_count``, with the
    call's ``seen``)."""

    @staticmethod
    def forward(ctx, live, fixed, w, temperature, count, seen):
        global launches
        out, lse_live, lse_fixed, name = _forward(live, fixed, w,
                                                  temperature)
        _count(name, seen)
        launches += count
        ctx.save_for_backward(live, fixed, w, out, lse_live, lse_fixed)
        ctx.temperature, ctx.count, ctx.seen = temperature, count, seen
        return out

    @staticmethod
    def backward(ctx, g_bar):
        global bwd_launches
        dlive, dfixed, name = _backward(*ctx.saved_tensors, g_bar,
                                        ctx.temperature,
                                        ctx.needs_input_grad[1])
        bwd_launches += ctx.count
        _count(name, ctx.seen)
        return dlive, dfixed, None, None, None, None


def kl_mutual_pair(live, fixed, pair_w, *, temperature: float = 1.0):
    """Differentiable pair-weighted Eq. 2: live (Kl, B, V) x fixed
    (Kg, B, V) with (Kl, Kg) weights -> (Kl, B) fp32.  Pass
    ``fixed = live.detach()`` (or received predictions) for the federated
    gradient semantics; the fixed side's gradient is then never computed,
    and the square kernel reads the logits once.
    """
    if all(t.device.type == "cpu" for t in (live, fixed, pair_w)):
        return ref.mutual_kl_pair(live, fixed, pair_w,
                                  temperature=temperature)
    _check(live, fixed, pair_w)
    if live.device.type != "cuda":
        raise ValueError(f"kl_mutual_pair runs on CUDA or CPU tensors, not "
                         f"{live.device}")
    w = pair_w.detach().to(dtype=torch.float32)
    seen = set()

    def block(a, b, wb):
        return _KlMutualPair.apply(a, b, wb.contiguous(), float(temperature),
                                   int(not seen), seen)
    return blocked_pair(block, live, fixed, w)


def kl_mutual(logits, *, temperature: float = 1.0):
    """Forward-only Eq. 2, logits (K, B, V) -> (K, B) fp32 average pairwise
    KL, w = (1 - I) / (K - 1): the square kernel (and, past MAX_CLIENTS,
    the pair kernel off the diagonal blocks)."""
    global mutual_kl_launches
    if logits.device.type == "cpu":
        return ref.mutual_kl(logits, temperature=temperature)
    K = logits.shape[0]
    w = (1.0 - torch.eye(K, device=logits.device)) / max(K - 1, 1)
    _check(logits, logits, w)
    if logits.device.type != "cuda":
        raise ValueError(f"kl_mutual runs on CUDA or CPU tensors, not "
                         f"{logits.device}")
    x = logits.detach()
    seen = set()

    def block(a, b, wb):
        out, _, _, name = _forward(a, b, wb.contiguous(), float(temperature))
        _count(name, seen)
        return out
    out = blocked_pair(block, x, x, w)
    mutual_kl_launches += 1
    return out
