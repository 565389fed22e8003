"""The port's public surface against the JAX package's, on the CPU: the
top-level package (``repro_torch.Federation is repro_torch.api.Federation``,
lazy, an unknown name refused), ``models.transformer.forward_hidden`` on
reduced qwen3-4b, mamba2-780m and qwen2-moe-a2.7b, ``ModelConfig.attn_free``
for every arch, ``kernels.ops.resolve_impl``'s order (explicit >
``REPRO_KERNEL_IMPL`` > the device's default) and the training CLI's
``--kernel-impl auto``.

Tolerances, fp32: the hidden states (before the final norm) within 2e-4
of each tensor's largest magnitude (random-init MoE experts give hidden
states of hundreds; the two packages sum the same products in another
order), the aux losses atol/rtol 1e-5, as ``tests/test_torch_moe.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as jtfm
from repro_torch import api, interop
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.kernels import ops
from repro_torch.launch import train as cli
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
AUX = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the top-level package

def test_top_level_import_contract():
    """``repro_torch`` exports the JAX package's stable surface, as
    ``tests/test_api.py::test_top_level_import_contract`` holds ``repro``."""
    import repro
    assert repro_torch.__version__ == repro.__version__
    assert set(repro.__all__) <= set(repro_torch.__all__)
    assert set(repro_torch.__all__) - set(repro.__all__) == {"interop"}
    assert repro_torch.Federation is api.Federation
    assert repro_torch.DML is api.DML and repro_torch.SparseDML is \
        api.SparseDML
    assert repro_torch.FedAvg is api.FedAvg and repro_torch.AsyncWeights is \
        api.AsyncWeights
    assert repro_torch.VisionClients is api.VisionClients
    for name in repro_torch.__all__:
        if name in ("api", "checkpoint", "interop", "__version__"):
            continue
        assert getattr(repro_torch, name) is getattr(api, name), name
    assert repro_torch.api is api
    assert repro_torch.checkpoint.save and repro_torch.interop is interop
    assert repro_torch.core.api.Federation is api.Federation
    assert repro_torch.sharding.ClientMesh
    assert {n for n in repro_torch.__all__ if not n.startswith("_")} <= \
        set(dir(repro_torch))
    with pytest.raises(AttributeError, match="no_such_symbol"):
        repro_torch.no_such_symbol


def test_import_is_lazy():
    """``import repro_torch`` loads no session code and no JAX; the first
    name asked for loads ``repro_torch.api`` (in a fresh interpreter)."""
    code = (
        "import sys\n"
        "import repro_torch\n"
        "early = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro') or m.startswith('repro_torch.'))\n"
        "assert not early, early\n"
        "repro_torch.Federation\n"
        "assert 'repro_torch.core.api' in sys.modules\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


# ---------------------------------------------------------------------------
# forward_hidden and attn_free

@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m",
                                  "qwen2-moe-a2.7b"])
def test_forward_hidden_matches_jax(arch):
    """The single-model backbone: hidden states and aux losses against
    ``repro.models.transformer.forward_hidden`` at "ref", the JAX params
    carried over; ``forward`` is ``forward_hidden`` and the head."""
    cfg, tcfg = jget_reduced(arch), get_reduced(arch)
    params = jax.jit(lambda k: jtfm.init_model(k, cfg))(
        jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want, waux = jax.jit(lambda p, t: jtfm.forward_hidden(
        p, cfg, t, remat=False, impl="ref"))(params, jnp.asarray(toks))
    ttoks = torch.as_tensor(toks, dtype=torch.long)
    got, aux = tfm.forward_hidden(tparams, tcfg, ttoks, remat=False,
                                  unroll=True, impl="ref")
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 32, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-4 * np.abs(want).max())
    assert sorted(aux) == sorted(waux) == ["load_balance", "router_z"]
    for key in aux:
        assert aux[key].shape == ()
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(waux[key]),
                                   **AUX)
    if tcfg.moe is not None:
        assert float(aux["load_balance"]) > 0

    calls = []
    inner = tfm.forward_hidden

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)
    try:
        tfm.forward_hidden = counted
        logits = tfm.forward(tparams, tcfg, ttoks, remat=False, impl="ref")
    finally:
        tfm.forward_hidden = inner
    assert calls == [1]
    head = tfm._unembed(tfm._stack1(tparams), tcfg, got[None])[0]
    assert torch.equal(logits, head)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_attn_free_matches_jax(arch):
    assert len(ARCH_IDS) == 10
    for get, jget in ((get_config, jget_config),
                      (get_reduced, jget_reduced)):
        assert get(arch).attn_free is jget(arch).attn_free
    assert get_config(arch).attn_free is (arch == "mamba2-780m")


# ---------------------------------------------------------------------------
# the impl policy

def test_resolve_impl_order(monkeypatch):
    """Explicit > REPRO_KERNEL_IMPL > the device's default; None and "auto"
    defer; a value outside IMPLS raises ValueError, as JAX's
    ``_check_impl``; "cuda" on the CPU raises, from either source."""
    monkeypatch.delenv("REPRO_KERNEL_IMPL", raising=False)
    assert ops.resolve_impl(None, "cpu") == "ref"
    assert ops.resolve_impl("auto", "cpu") == "ref"
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
    assert ops.resolve_impl(None, "cpu") == "ref"
    assert ops.resolve_impl("auto", "cpu") == "ref"
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "cuda")
    assert ops.resolve_impl("ref", "cpu") == "ref"      # explicit first
    for impl in (None, "auto"):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            ops.resolve_impl(impl, "cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ops.resolve_impl("cuda", "cpu")
    for bad in ("interpret", "pallas", "triton"):
        monkeypatch.setenv("REPRO_KERNEL_IMPL", bad)
        with pytest.raises(ValueError, match="unknown kernel impl"):
            ops.resolve_impl(None, "cpu")
        assert ops.resolve_impl("ref", "cpu") == "ref"
        monkeypatch.delenv("REPRO_KERNEL_IMPL")
        with pytest.raises(ValueError, match="unknown kernel impl"):
            ops.resolve_impl(bad, "cpu")
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "")         # empty: unset
    assert ops.resolve_impl(None, "cpu") == "ref"


def test_train_cli_kernel_impl_auto(capsys, monkeypatch):
    """``--kernel-impl auto`` (the default, as in the JAX CLI) resolves
    per device and defers to REPRO_KERNEL_IMPL."""
    monkeypatch.delenv("REPRO_KERNEL_IMPL", raising=False)
    args = ["--steps", "1", "--seq", "16", "--batch", "2", "--device",
            "cpu"]
    assert cli.main(args + ["--kernel-impl", "auto"]) == 0
    assert "kernels ref" in capsys.readouterr().out
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "cuda")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        cli.main(args)
    assert cli.main(args + ["--kernel-impl", "ref"]) == 0
    with pytest.raises(SystemExit):
        cli.main(args + ["--kernel-impl", "interpret"])
