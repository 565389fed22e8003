"""Kernel entry points and the policy of where the port runs.

impl values:
  - "ref":  the plain PyTorch version (``kernels/ref.py``); runs anywhere.
  - "cuda": the hand-written CUDA kernels; CUDA tensors only.

There is no ambient default: an entry point (an engine, a CLI) resolves
its impl ONCE from its device with ``resolve_impl`` and passes it down as a
plain argument to every call that can reach a kernel.

On a data x model mesh (``sharding.use_mesh``) the arguments are DTensors,
and each entry point runs its kernel (or, at "ref", its plain version) on
every rank's local shards through ``local_map``, as XLA runs a custom
call it cannot partition on the shards it is handed:

  - attention and the SSD scan are local over their batch (and client)
    dims and their heads; a head dim is kept sharded only where q and the
    keys (or x and the B/C groups) are sharded alike, so that each rank's
    query heads meet their own key/value groups;
  - the Eq.-2 kernels and the sparse KL take the vocabulary whole: their
    logits are redistributed to ``Replicate()`` on the vocab's mesh dim,
    and the fixed side (or the received top-k sets) on the client's too,
    so that each rank's live clients meet every sender; then they run on
    the local (client, batch) shard.

Every other placement of an argument (a sharded sequence, a partial sum)
is redistributed to ``Replicate()`` first.  No kernel falls back to its
plain version under a mesh: the impl the caller passed runs.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import kl_mutual, ref, sparse_kl, ssd_scan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.sharding.local import (drop_shard, keep_shards, local_call,
                                        replicated)

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


# ---------------------------------------------------------------------------
# DTensor arguments: the kernel on each rank's local shards

def _attention_local(q, k, v, causal, window, impl):
    """Self-attention of DTensors (..., S, H, hd) on each rank's (batch,
    heads) shard; the leading dims are folded into the batch locally.
    Where a mesh dim splits the query heads but not the key/value groups
    (Hkv not a multiple of its size), each rank's query heads lie in one
    group: the keys and values stay whole on that dim and each rank takes
    its group's head, their gradients summed over the dim (``Partial``),
    as XLA partitions a GQA product with replicated keys."""
    from torch.distributed.tensor import Partial
    mesh = q.device_mesh
    nd = q.dim()
    H, Hkv = q.shape[-2], k.shape[-2]
    g = H // Hkv
    place = keep_shards(q, set(range(nd - 3)) | {nd - 2})
    kv, grad, split = list(place), None, None
    for i, (p, n) in enumerate(zip(place, mesh.shape)):
        if not (isinstance(p, Shard) and p.dim == nd - 2) or Hkv % n == 0:
            continue
        Hl = H // n
        if split is None and Hl < g and g % Hl == 0:
            split = (i, Hl)
            kv[i] = Replicate()
            grad = [Partial() if j == i else p for j, p in enumerate(kv)]
        else:
            place[i] = kv[i] = Replicate()

    def fn(ql, kl, vl):
        if split is not None:
            i, Hl = split
            j = mesh.get_local_rank(i) * Hl // g
            kl, vl = kl[..., j:j + 1, :], vl[..., j:j + 1, :]
        lead = ql.shape[:-3]
        out = attention(ql.flatten(0, -4), kl.flatten(0, -4),
                        vl.flatten(0, -4), causal=causal, window=window,
                        impl=impl)
        return out.unflatten(0, lead)
    grads = None if grad is None else (place, grad, grad)
    return local_call(fn, place, (place, kv, kv), mesh, q, k, v,
                      grad_placements=grads)


def _kl_placements(live):
    """Local placements of Eq.-2 logits (K, B, V): the client and batch
    dims as they are, the vocabulary whole; the fixed side's and the
    received sets' clients whole too; the pair weights' rows as the live
    clients."""
    lp = keep_shards(live, {0, 1})
    fp = drop_shard(lp, 0)
    wp = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in lp]
    return lp, fp, wp


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              positions_q=None, positions_k=None,
              impl: Optional[str] = None):
    """(B, S, H, hd)-layout attention: the flash kernel or the plain version.
    DTensors may carry more leading batch dims (the client axis); they run
    on each rank's (batch, heads) shard.

    Explicit positions (the decode/cache path) always take the plain
    version, as ``repro/kernels/ops.py:100-103`` does, and need no impl.
    Self-attention (training, prefill and prompt scoring) runs the caller's
    ``impl``, which it must give.  Differentiable on every impl: "cuda"
    runs the CUDA backward, "ref" gets its gradient from autograd.
    """
    if impl is not None:
        _check_impl(impl)
    if isinstance(q, DTensor) and positions_q is None \
            and positions_k is None:
        return _attention_local(q, k, v, causal, window, impl)
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
    if isinstance(logits, DTensor):
        place = drop_shard(_kl_placements(logits)[0], 0)
        return local_call(lambda x: mutual_kl(x, temperature=temperature,
                                              impl=impl),
                          place, (place,), logits.device_mesh, logits)
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
    if isinstance(live, DTensor):
        return _pair_local(live, fixed, pair_w, temperature, impl)
    if impl == "ref":
        return ref.mutual_kl_pair(live, fixed, pair_w,
                                  temperature=temperature)
    if not live.is_cuda:
        raise ValueError("impl 'cuda' needs CUDA tensors, got "
                         f"{live.device}")
    return kl_mutual.kl_mutual_pair(live, fixed, pair_w,
                                    temperature=temperature)


def _pair_local(live, fixed, pair_w, temperature, impl):
    """``mutual_kl_pair`` of DTensors on each rank's (client, batch)
    shard.  The square case (``fixed`` a detached view of ``live``) stays
    square when the clients are whole on every rank: the local fixed side
    is then the local live side detached."""
    mesh = live.device_mesh
    lp, fp, wp = _kl_placements(live)
    w = replicated(pair_w, mesh)
    if isinstance(fixed, DTensor) and lp == fp and kl_mutual.same_tensor(
            live.to_local(), fixed.to_local()):
        return local_call(lambda x, wl: mutual_kl_pair(
            x, x.detach(), wl, temperature=temperature, impl=impl),
            lp, (lp, wp), mesh, live, w)
    return local_call(lambda x, f, wl: mutual_kl_pair(
        x, f, wl, temperature=temperature, impl=impl),
        lp, (lp, fp, wp), mesh, live, replicated(fixed, mesh), w)


def sparse_mutual_kl(live, idx, logp_top, pair_w, *,
                     temperature: float = 1.0, impl: str):
    """Pair-weighted Eq. 2 against RECEIVED sparse (top-k) predictions:
    live (Kl, B, V) x idx/logp_top (J, B, k) with (Kl, J) weights ->
    (Kl, B).  Differentiable on the live side at every impl: "cuda" runs
    the sparse-KL kernel and its backward, "ref" the plain version under
    autograd.  The SparseDML hot path (``core.mutual.sparse_mutual_kl_loss``
    and ``sparse_kl_to_received`` route here)."""
    _check_impl(impl)
    if isinstance(live, DTensor):
        mesh = live.device_mesh
        lp, fp, wp = _kl_placements(live)
        return local_call(lambda x, i, lt, wl: sparse_mutual_kl(
            x, i, lt, wl, temperature=temperature, impl=impl),
            lp, (lp, fp, fp, wp), mesh, live, replicated(idx, mesh),
            replicated(logp_top, mesh), replicated(pair_w, mesh))
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
    if isinstance(x, DTensor):
        raise ValueError("a sharded SSD scan runs through ssd_clients")
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


def _heads(t):
    """(K, B, S, H, ...) -> (B, S, K*H, ...): the clients become heads."""
    t = t.movedim(0, 2)
    return t.reshape(*t.shape[:2], -1, *t.shape[4:])


def _clients(t, K: int, dim: int):
    """Undo ``_heads`` along ``dim``: (..., K*H, ...) -> K leading."""
    t = t.unflatten(dim, (K, -1))
    return t.movedim(dim, 0)


def ssd_clients(x, dt, A, B_mat, C_mat, *, chunk: int = 256, impl: str):
    """The SSD scan of K clients in one call: x (K, B, S, H, P), dt
    (K, B, S, H), A (K, H), B/C (K, B, S, G, N) -> (y (K, B, S, H, P),
    final state (K, B, H, P, N)).  The clients become heads (x as
    (B, S, K*H, P), B/C as (B, S, K*G, N), so head k*H + h reads group
    k*G + h // (H/G) with client k's decay rates), and one ``ssd`` call
    serves them all.  DTensors run on each rank's (client, batch, heads)
    shard: the groups are sharded with the heads where they divide, and
    the heads replicated where they do not."""
    if isinstance(x, DTensor):
        return _ssd_local(x, dt, A, B_mat, C_mat, chunk, impl)
    K = x.shape[0]
    y, state = ssd(_heads(x).contiguous(), _heads(dt).contiguous(),
                   A.reshape(-1), _heads(B_mat).contiguous(),
                   _heads(C_mat).contiguous(), chunk=chunk, impl=impl)
    return _clients(y, K, 2), _clients(state, K, 1)


def _ssd_local(x, dt, A, B_mat, C_mat, chunk, impl):
    mesh = x.device_mesh
    G = B_mat.shape[3]
    xp = keep_shards(x, {0, 1, 3})
    for i, (p, n) in enumerate(zip(xp, mesh.shape)):
        if isinstance(p, Shard) and p.dim == 3 and G > 1 and G % n:
            xp[i] = Replicate()
    heads = [isinstance(p, Shard) and p.dim == 3 for p in xp]
    bp = [Shard(3) if h and G > 1 else (p if not h else Replicate())
          for p, h in zip(xp, heads)]
    ap = [Shard(1) if h else (p if isinstance(p, Shard) and p.dim == 0
                              else Replicate()) for p, h in zip(xp, heads)]
    sp = [Shard(2) if h else p for p, h in zip(xp, heads)]
    # partial sums: A has no batch dim, so where the batch is split a
    # rank's gradient of A is its rows' part; B and C whole over a split
    # of the heads get from each rank its heads' part
    from torch.distributed.tensor import Partial
    ag = [Partial() if isinstance(p, Shard) and p.dim == 1 else a
          for p, a in zip(xp, ap)]
    bg = [Partial() if h and not isinstance(b, Shard) else b
          for b, h in zip(bp, heads)]

    def fn(xl, dtl, al, bl, cl):
        return ssd_clients(xl, dtl, al, bl, cl, chunk=chunk, impl=impl)
    return local_call(fn, (xp, sp), (xp, xp, ap, bp, bp), mesh, x, dt, A,
                      B_mat, C_mat, grad_placements=(xp, xp, ag, bg, bg))
