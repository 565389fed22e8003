"""AdamW over a whole tree in hand-written CUDA kernels: one global
sum-of-squares pass over the gradients and one multi-tensor update of
params and fp32 moments, in place (``csrc/adamw_fused.cu``).

The kernels replace no TPU kernel: the JAX package leaves AdamW to XLA's
fusion.  ``repro_torch.optim.adamw_update`` sends CUDA leaves here and
keeps its eager loop, the plain version, for CPU and meta leaves.  The
update is bound by bytes: each gradient is read once for the norm, then
p, g, mu and nu are read once and p, mu and nu written once.

The leaves travel as a table passed by value as a kernel argument (so no
host-to-device copy and no host sync precede a launch), at most
``MAX_LEAVES`` to a table so that the arguments stay under the 4 KB limit
every CUDA toolkit takes; a longer tree is launched table by table.  A
gradient may be contiguous or, as a tied head's comes back, the
transpose of a dense matrix in its last two axes (``TRANS``: the update
reads it tile by tile).  On a CUDA leaf the wrappers launch or raise: a
param or moment that is not contiguous, a gradient in another layout, a
dtype other than bf16 or fp32 (params and gradients) or fp32 (moments),
or another device raises before anything is launched.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_LEAVES = 48
CHUNK = 16384          # elements of a leaf a block takes at a time
TILE = 64              # rows and cols of a TRANS leaf's tile
SUMSQ_BLOCKS = 1024    # partial sums one table's norm pass writes
ARG_LIMIT = 4096       # bytes of kernel arguments every toolkit takes
DTYPES = (torch.float32, torch.bfloat16)
# Leaf.flags
DECAY, P_BF16, G_BF16, VEC_G, VEC_ALL, TRANS = 1, 2, 4, 8, 16, 32
# Hyper.scale_mode: no gradient scale, one device scalar, one a client
SCALE_NONE, SCALE_ONE, SCALE_CLIENT = 0, 1, 2
VEC = 8                # elements a thread moves at a time where aligned

# kernel launches in this process
launches = 0


class Leaf(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("mu", ctypes.c_void_p), ("nu", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("per_client", ctypes.c_longlong),
                ("rows", ctypes.c_longlong), ("cols", ctypes.c_longlong),
                ("chunk0", ctypes.c_int), ("flags", ctypes.c_int)]


class Table(ctypes.Structure):
    _fields_ = [("leaf", Leaf * MAX_LEAVES), ("n_leaves", ctypes.c_int),
                ("n_chunks", ctypes.c_int)]


class Hyper(ctypes.Structure):
    _fields_ = [("scale", ctypes.c_void_p), ("scale_mode", ctypes.c_int)] + [
        (f, ctypes.c_float) for f in ("b1", "one_minus_b1", "b2",
                                      "one_minus_b2", "inv_bc1", "inv_bc2",
                                      "eps", "wd", "neg_lr")]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("adamw_fused")
    lib.adamw_abi.argtypes = [ctypes.c_void_p]
    lib.adamw_sumsq.argtypes = [ctypes.c_void_p] * 3
    lib.adamw_norm.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                               ctypes.c_void_p]
    lib.adamw_apply.argtypes = [ctypes.c_void_p] * 3
    for f in (lib.adamw_abi, lib.adamw_sumsq, lib.adamw_norm,
              lib.adamw_apply):
        f.restype = ctypes.c_int
    abi = (ctypes.c_longlong * 7)()
    lib.adamw_abi(abi)
    want = (ctypes.sizeof(Leaf), ctypes.sizeof(Table), ctypes.sizeof(Hyper),
            MAX_LEAVES, CHUNK, SUMSQ_BLOCKS, TILE)
    if tuple(abi) != want:
        raise RuntimeError(f"adamw_fused.cu's layout {tuple(abi)} is not "
                           f"the wrapper's {want}")
    return lib


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def tables(entries) -> list:
    """The leaves as ``Table``s of at most ``MAX_LEAVES`` each, in order.
    ``entries``: (p, g, mu, nu, per_client, decay, trans) per leaf, with
    p, mu and nu None for the norm pass; ``per_client`` is the elements
    of one client where a per-client scale applies, else 0; ``trans`` the
    (rows, cols) of a gradient stored transposed, else None.  Empty
    leaves are left out.  A leaf's chunks (CHUNK elements, or a TRANS
    leaf's TILE x TILE tiles) are numbered on from the table's previous
    leaf; its flags carry its dtypes, decay and 16-byte alignment (a
    per-client leaf moves 8 elements a step only where each step lies in
    one client, a TRANS one where rows and cols are multiples of 8)."""
    out, t = [], None
    for p, g, mu, nu, per_client, decay, trans in entries:
        n = g.numel()
        if n == 0:
            continue
        if t is None or t.n_leaves == MAX_LEAVES:
            t = Table()
            out.append(t)
        whole = p is not None
        rows, cols = trans or (0, 0)
        steps = (per_client % VEC == 0 if trans is None
                 else rows % VEC == 0 and cols % VEC == 0)
        flags = ((DECAY if decay else 0)
                 | (P_BF16 if whole and p.dtype == torch.bfloat16 else 0)
                 | (G_BF16 if g.dtype == torch.bfloat16 else 0)
                 | (VEC_G if _aligned(g) else 0)
                 | (VEC_ALL if whole and _aligned(p, g, mu, nu) and steps
                    else 0)
                 | (TRANS if trans else 0))
        t.leaf[t.n_leaves] = Leaf(
            p.data_ptr() if whole else None, g.data_ptr(),
            mu.data_ptr() if whole else None,
            nu.data_ptr() if whole else None, n, per_client, rows, cols,
            t.n_chunks, flags)
        t.n_leaves += 1
        t.n_chunks += (-(-n // CHUNK) if trans is None else
                       n // (rows * cols) * -(-rows // TILE) * -(-cols // TILE))
    return out


def _device(ts) -> torch.device:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"the fused AdamW runs on CUDA tensors, not {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"leaves on {dev} and {t.device}")
    return dev


def _dense(t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"a non-contiguous leaf {tuple(t.shape)} with "
                         f"strides {t.stride()}")


def transposed(g: torch.Tensor):
    """(rows, cols) where ``g`` is not contiguous but is the transpose of
    a contiguous tensor in its last two axes, as a tied head's gradient
    is; None where it is contiguous.  Raises on any other layout."""
    if g.is_contiguous():
        return None
    if g.dim() >= 2 and g.transpose(-1, -2).is_contiguous():
        return tuple(g.shape[-2:])
    raise ValueError(f"a gradient {tuple(g.shape)} with strides "
                     f"{g.stride()}: neither contiguous nor transposed")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def plan_sumsq(grads) -> list:
    """The tables of ``sumsq``'s gradients; raises on a gradient the
    kernel does not take."""
    for g in grads:
        transposed(g)                  # stored dense either way
        if g.dtype not in DTYPES:
            raise ValueError(f"want gradients in {DTYPES}; got {g.dtype}")
    return tables((None, g, None, None, 0, False, None) for g in grads)


def sumsq(grads, norm: bool = True, clip=None) -> torch.Tensor:
    """A (3,) fp32 tensor on the gradients' device: the sum of squares of
    every element of ``grads`` (a list of tensors), then, with ``norm``,
    its square root, then, with ``clip``, min(1, clip / max(norm, 1e-9))
    (entries not asked for are left unwritten)."""
    global launches
    grads = list(grads)
    if not grads:
        raise ValueError("no gradients")
    dev = _device(grads)
    tabs = plan_sumsq(grads)
    with torch.cuda.device(dev):
        parts = torch.empty(len(tabs) * SUMSQ_BLOCKS, dtype=torch.float32,
                            device=dev)
        out = torch.empty(3, dtype=torch.float32, device=dev)
        stream = _stream(dev)
        for i, t in enumerate(tabs):
            _raise(_lib().adamw_sumsq(
                ctypes.byref(t), parts.data_ptr() + 4 * i * SUMSQ_BLOCKS,
                stream), "adamw_sumsq")
        _raise(_lib().adamw_norm(
            parts.data_ptr(), parts.numel(), out.data_ptr(),
            0 if not norm else 1 if clip is None else 2,
            0.0 if clip is None else clip, stream), "adamw_norm")
    launches += len(tabs) + 1
    return out


def plan_update(leaves, scale) -> tuple:
    """(tables, scale mode) of ``update``'s leaves; raises on a leaf or a
    scale the kernel does not take.  A (K,) scale gives each leaf its
    elements per client: the leaf's leading axis holds the K clients."""
    mode = SCALE_NONE if scale is None else (
        SCALE_ONE if scale.dim() == 0 else SCALE_CLIENT)
    if scale is not None and (scale.dtype != torch.float32
                              or scale.dim() > 1
                              or not scale.is_contiguous()):
        raise ValueError(f"want a 0-d or (K,) contiguous fp32 scale; got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    entries = []
    for p, g, mu, nu, decay in leaves:
        if not p.shape == g.shape == mu.shape == nu.shape:
            raise ValueError(f"shapes differ: {tuple(p.shape)}, "
                             f"{tuple(g.shape)}, {tuple(mu.shape)}, "
                             f"{tuple(nu.shape)}")
        if p.dtype not in DTYPES or g.dtype not in DTYPES \
                or mu.dtype != torch.float32 or nu.dtype != torch.float32:
            raise ValueError(f"want params and gradients in {DTYPES} and "
                             f"fp32 moments; got {p.dtype}, {g.dtype}, "
                             f"{mu.dtype}, {nu.dtype}")
        for t in (p, mu, nu):
            _dense(t)
        trans = transposed(g)
        per_client = 0
        if mode == SCALE_CLIENT:
            if p.dim() == 0 or p.shape[0] != scale.numel():
                raise ValueError(f"a ({scale.numel()},) client scale on a "
                                 f"leaf {tuple(p.shape)}")
            per_client = p.numel() // p.shape[0]
        entries.append((p, g, mu, nu, per_client, decay, trans))
    return tables(entries), mode


def update(leaves, scale, *, lr: float, b1: float, b2: float, eps: float,
           weight_decay: float, bc1: float, bc2: float) -> None:
    """One AdamW step of ``leaves``, (p, g, mu, nu, decay) each, in place;
    each gradient is first multiplied by ``scale``: None, a 0-d fp32
    tensor, or a (K,) one with an entry for each client of every leaf's
    leading axis."""
    global launches
    leaves = list(leaves)
    if not leaves:
        return
    dev = _device([t for leaf in leaves for t in leaf[:4]]
                  + ([] if scale is None else [scale]))
    tabs, mode = plan_update(leaves, scale)
    # PyTorch divides by a host scalar through its fp32 reciprocal
    inv = lambda x: float(np.float32(1.0) / np.float32(x))  # noqa: E731
    hyper = Hyper(None if scale is None else scale.data_ptr(), mode,
                  b1, 1 - b1, b2, 1 - b2, inv(bc1), inv(bc2), eps,
                  weight_decay, -lr)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        for t in tabs:
            _raise(_lib().adamw_apply(ctypes.byref(t), ctypes.byref(hyper),
                                      stream), "adamw_apply")
    launches += len(tabs)
