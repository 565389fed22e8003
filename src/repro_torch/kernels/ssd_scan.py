"""Mamba2 SSD chunked scan, forward and backward: hand-written CUDA kernels
for Hopper behind one ``torch.autograd.Function``.

The forward replaces the TPU kernel ``repro/kernels/ssd_scan.py:35``
(``_ssd_kernel`` behind ``_ssd_forward``), the backward the plain-JAX
``_ssd_chunk_bwd`` of its custom VJP (:154-198).  The kernel sources are
``csrc/ssd_scan_fwd.cu`` and ``csrc/ssd_scan_bwd.cu``; their headers say
what bounds them on the H100 and what the design does about it.  They are
built with ``nvcc`` at first use (``_build``) and called through ctypes.
bf16 inputs run Mamba2's three steps on the bf16 tensor cores (chunk
states, a sequential pass over the chunks, chunk outputs; ``csrc/
ssd_tc.cuh``), with each score tile computed once for a run of a group's
heads; fp32 inputs run the exact fp32 FMA kernels.  Each entry point's C
function starts several kernels on the current stream and takes an fp32
scratch that the wrapper allocates (its size from ``*_workspace``).

``ssd_scan`` has the contract of the JAX ``ssd_scan`` (:223): x (B, S, H,
P), dt (B, S, H), A (H,), B/C (B, S, G, N) with H % G == 0, zero initial
state -> (y (B, S, H, P) in x's dtype, final_state (B, H, P, N) fp32).  On
CUDA tensors it launches the kernels or raises: x, B and C of one dtype
(fp32 or bf16), dt and A fp32, every tensor contiguous, P <= 64, N <= 128
and chunk <= 256.  The forward also writes every chunk's entry state (B,
H, nc, P, N) fp32, which the backward replays from; a ``None`` gradient of
the final state counts as zero.  On CPU tensors it runs the plain version
``ref.ssd``, and autograd gives its gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256
HEAD_RUN = 8      # heads a bf16 block shares its score tiles with (ssd_tc.cuh)

# kernel launches in this process, one per call of each entry point;
# chip_smoke.py reads them to show that a path went through the kernels
launches = 0
bwd_launches = 0


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_ptr: int):
    """The C entry point ``name`` of ``csrc/<name>.cu`` (``n_ptr`` pointers,
    eight ints, the stream) and its scratch size function, built at first
    use."""
    lib = _build.load(name)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = getattr(lib, f"{name}_workspace")
    ws.argtypes = [ctypes.c_int] * 8
    ws.restype = ctypes.c_longlong
    return fn, ws


def _workspace(ws_fn, x, shape_args):
    """The fp32 scratch a C entry point asks for."""
    n = ws_fn(*shape_args)
    return torch.empty((max(n, 1),), dtype=torch.float32, device=x.device)


def _check(x, dt, A, B_mat, C_mat, chunk: int) -> None:
    """What the kernels take."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_mat.dim() != 4 \
            or B_mat.shape != C_mat.shape:
        raise ValueError(
            f"want x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(B_mat.shape)}, {tuple(C_mat.shape)}")
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    if tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,) \
            or tuple(B_mat.shape[:2]) != (Bb, S):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)} or B/C "
                         f"{tuple(B_mat.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    if S == 0 or Bb == 0 or H == 0:
        raise ValueError("empty batch, sequence or heads")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"P={P}, N={N}: the kernels take P <= {MAX_P} and "
                         f"N <= {MAX_N}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in 1..{MAX_CHUNK}")
    if x.dtype not in DTYPES or B_mat.dtype != x.dtype \
            or C_mat.dtype != x.dtype:
        raise ValueError(f"want x, B, C of one dtype in {DTYPES}; got "
                         f"{x.dtype}, {B_mat.dtype}, {C_mat.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"want dt and A in float32; got {dt.dtype}, "
                         f"{A.dtype}")
    if not (x.device == dt.device == A.device == B_mat.device
            == C_mat.device):
        raise ValueError("x, dt, A, B, C on different devices")
    if not all(t.is_contiguous() for t in (x, dt, A, B_mat, C_mat)):
        raise ValueError("the SSD kernels take contiguous tensors")
    if Bb * G * -(-(H // G) // HEAD_RUN) >= 2 ** 16:
        raise ValueError(f"batch {Bb} x {G} groups exceeds the launch grid")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(x, dt, A, B_mat, C_mat, chunk: int):
    """Launches the forward kernel; returns (y, final_state, states_in)."""
    global launches
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    nc = -(-S // chunk)
    shape = (Bb, S, H, P, G, N, chunk, int(x.dtype == torch.bfloat16))
    fn, ws_fn = _entry("ssd_scan_fwd", 9)
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        final = torch.empty((Bb, H, P, N), dtype=torch.float32,
                            device=x.device)
        states = torch.empty((Bb, H, nc, P, N), dtype=torch.float32,
                             device=x.device)
        ws = _workspace(ws_fn, x, shape)
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(),
                C_mat.data_ptr(), y.data_ptr(), final.data_ptr(),
                states.data_ptr(), ws.data_ptr(), *shape, _stream(x))
    if rc != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed with CUDA error {rc}")
    launches += 1
    return y, final, states


def _backward(x, dt, A, B_mat, C_mat, states, dy, dstate, chunk: int):
    """Launches the backward kernels; returns (dx, ddt, dA, dB, dC) in
    their inputs' dtypes.  ``dy`` and ``dstate`` may be None (zero)."""
    global bwd_launches
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    dy = torch.zeros_like(x) if dy is None else \
        dy.to(x.dtype).contiguous()
    if dstate is not None:
        dstate = dstate.float().contiguous()
    shape = (Bb, S, H, P, G, N, chunk, int(x.dtype == torch.bfloat16))
    fn, ws_fn = _entry("ssd_scan_bwd", 14)
    with torch.cuda.device(x.device):
        f32 = dict(dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        ddt = torch.empty((Bb, S, H), **f32)
        dA_part = torch.empty((Bb, H), **f32)
        dB = torch.empty_like(B_mat)
        dC = torch.empty_like(C_mat)
        ws = _workspace(ws_fn, x, shape)
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(),
                C_mat.data_ptr(), states.data_ptr(), dy.data_ptr(),
                None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
                ddt.data_ptr(), dA_part.data_ptr(), dB.data_ptr(),
                dC.data_ptr(), ws.data_ptr(), *shape, _stream(x))
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed with CUDA error {rc}")
    bwd_launches += 1
    return dx, ddt, dA_part.sum(dim=0), dB, dC


class _SSDScan(torch.autograd.Function):
    """The CUDA forward, saving (x, dt, A, B, C, entry states) for the CUDA
    backward."""

    @staticmethod
    def forward(ctx, x, dt, A, B_mat, C_mat, chunk):
        y, final, states = _forward(x, dt, A, B_mat, C_mat, chunk)
        ctx.save_for_backward(x, dt, A, B_mat, C_mat, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B_mat, C_mat, states = ctx.saved_tensors
        dx, ddt, dA, dB, dC = _backward(x, dt, A, B_mat, C_mat, states, dy,
                                        dstate, ctx.chunk)
        return dx, ddt, dA, dB, dC, None


def ssd_scan(x, dt, A, B_mat, C_mat, *, chunk: int = 256):
    """Mamba2 SSD from the zero state -> (y (B, S, H, P) in x.dtype,
    final_state (B, H, P, N) fp32), differentiable in x, dt, A, B and C.
    CPU tensors take ``ref.ssd``."""
    if all(t.device.type == "cpu" for t in (x, dt, A, B_mat, C_mat)):
        return ref.ssd(x, dt, A, B_mat, C_mat, chunk=chunk)
    _check(x, dt, A, B_mat, C_mat, int(chunk))
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    return _SSDScan.apply(x, dt, A, B_mat, C_mat, int(chunk))
