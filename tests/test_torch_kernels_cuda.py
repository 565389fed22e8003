"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one: a CUDA kernel
has no CPU mode (on CPU tensors the wrappers run the plain versions, which
the other ``test_torch_*`` files hold against the JAX package).  The module
imports no JAX, so it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # a full-fp32 reference
    return torch.device("cuda")


def _qkv(device, dtype, B=2, S=300, Hq=8, Hkv=4, hd=64, seed=0):
    """q, k, v as strided slices of one fused (B, S, Hq + 2 Hkv, hd)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(B, S, Hq + 2 * Hkv, hd, generator=gen,
                      device=device).to(dtype)
    return qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,window,causal", [(128, None, True),
                                              (64, 37, True),
                                              (32, None, False)])
def test_flash_kernel_matches_plain(cuda, dtype, hd, window, causal):
    """fp32: atol 1e-4 (summation order only); bf16: atol/rtol 2e-2 against
    the plain version on the same bf16 inputs (one rounding of out); lse
    atol 1e-3 (fp32 in both)."""
    q, k, v = _qkv(cuda, dtype, hd=hd)
    before = fa.launches
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window)
    want, want_lse = ref.attention_lse(q, k, v, causal=causal, window=window)
    assert fa.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol,
                               rtol=0 if dtype == torch.float32 else tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


def test_ops_cuda_impl_reaches_the_kernel(cuda):
    q, k, v = _qkv(cuda, torch.bfloat16)
    before = fa.launches
    got = ops.attention(q, k, v, impl="cuda")
    assert fa.launches == before + 1
    torch.testing.assert_close(got.float(), ref.attention(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    decode = ops.attention(q[:, -1:], k, v, impl="cuda",
                           positions_q=torch.full((2, 1), 299, device=cuda),
                           positions_k=torch.arange(300, device=cuda)
                           .expand(2, 300))
    assert fa.launches == before + 1          # explicit positions: plain
    torch.testing.assert_close(decode.float(), got[:, -1:].float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("bad", ["head_dim", "grad", "device"])
def test_flash_kernel_refuses_before_launch(cuda, bad):
    q, k, v = _qkv(cuda, torch.float32, hd=48 if bad == "head_dim" else 64)
    if bad == "grad":
        q = q.detach().requires_grad_(True)
    if bad == "device":
        k = k.cpu()
    before = fa.launches
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)
    assert fa.launches == before
