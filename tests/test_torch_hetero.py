"""The modules of the port's heterogeneous population against the JAX
package on the CPU: the per-client model registry (``models``), each
client's losses and logits with their gradients for the dense, SSM and
MoE families and VisionNet, ``core.mutual.kl_to_received``, and
``core.populations.hetero``'s ``make_lm_pool`` and
``comm_bytes_per_round``; the refusals ``HeteroClients`` raises before it
allocates anything.

JAX params cross through ``interop.params_from_numpy``; inputs come from
numpy with a seed.  Tolerances, fp32: values and gradients atol/rtol 1e-5
(the same math, summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs.visionnet import reduced as jvn_reduced
from repro.core import mutual as jmutual
from repro.core.populations.hetero import \
    comm_bytes_per_round as jcomm_bytes
from repro.core.populations.hetero import make_lm_pool as jmake_lm_pool
from repro.models import get_client_model as jget_client_model
from repro_torch import interop
from repro_torch.api import HeteroClients, comm_bytes_per_round, make_lm_pool
from repro_torch.checkpoint import flatten
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.visionnet import reduced as vn_reduced
from repro_torch.core import mutual
from repro_torch.kernels import ops
from repro_torch.models import get_client_model
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
FAMILIES = ("qwen3-4b", "mamba2-780m", "dbrx-132b")     # dense / ssm / moe


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **{**TOL, **kw})


def _trees_close(got, want):
    got, want = flatten(got), flatten(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# the registry

@pytest.mark.parametrize("arch", ARCH_IDS + ["visionnet"])
def test_registry_matches_jax(arch):
    """Families, kinds, prediction spaces and configs of every arch and of
    VisionNet, reduced and full; the prefix archs refused by both."""
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    for reduced in (True, False):
        if arch != "visionnet" and get_config(arch).prefix_tokens:
            cfg = get_reduced(arch) if reduced else get_config(arch)
            for fn in (get_client_model, jget_client_model):
                with pytest.raises(ValueError, match="prefix"):
                    fn(arch, reduced=reduced)
            with pytest.raises(ValueError, match="prefix"):
                get_client_model(cfg)
            continue
        got, want = (fn(arch, reduced=reduced) for fn in
                     (get_client_model, jget_client_model))
        assert (got.arch, got.family, got.kind, got.n_classes) == \
            (want.arch, want.family, want.kind, want.n_classes)
        for field in ("name", "n_layers", "d_model") if arch != \
                "visionnet" else ("name", "image_size", "conv_features"):
            assert getattr(got.cfg, field) == getattr(want.cfg, field)
        # a config object resolves to the same client, its name the id
        again = get_client_model(got.cfg)
        assert (again.arch, again.family, again.cfg) == \
            (got.arch, got.family, got.cfg)


def _pool():
    return make_lm_pool(60, 16, 512, seed=0)


def test_refusals_come_before_any_allocation(monkeypatch):
    """Modalities, then the shared V, then the byzantine map, in the JAX
    package's order and with its messages, before a single parameter is
    drawn; a valid byzantine map and payload recording pass the checks, as
    in the JAX package, and construction goes on to draw the params."""
    from repro_torch.models import transformer, visionnet

    def no_init(*a, **k):
        raise AssertionError("allocated before refusing")
    monkeypatch.setattr(transformer, "init_model", no_init)
    monkeypatch.setattr(visionnet, "init_visionnet", no_init)
    pool, labels = _pool()
    kw = dict(rounds=1, device="cpu")
    cases = [
        (("qwen3-4b", "visionnet"), {}, ValueError, "modalit"),
        # full configs: V 151,936 against 50,280 (no 50 GB drawn first)
        (("qwen3-4b", "mamba2-780m"), dict(reduced=False), ValueError,
         "prediction space"),
        (("qwen3-4b", "mamba2-780m", "dbrx-132b"), dict(reduced=False),
         ValueError, "prediction space"),
        (("qwen3-4b", "qwen3-4b"), dict(byzantine={2: "sign-flip"}),
         ValueError, "out of range"),
        (("qwen3-4b", "qwen3-4b"), dict(byzantine={0: "bogus"}), ValueError,
         "unknown byzantine"),
        (("qwen3-4b", "qwen3-4b"), dict(byzantine={0: "label-flip"}),
         ValueError, "label-flip"),
        (("qwen3-4b", "qwen3-4b"), dict(byzantine={1: "collude"}),
         AssertionError, "allocated"),
        (("qwen3-4b", "qwen3-4b"), dict(record_payloads=True),
         AssertionError, "allocated"),
        (("llava-next-mistral-7b",), {}, ValueError, "prefix"),
        (("qwen3-4b", get_reduced("qwen3-4b").replace(n_layers=4)), {},
         ValueError, "two configs"),
    ]
    for archs, extra, exc, match in cases:
        with pytest.raises(exc, match=match):
            HeteroClients(archs, pool, labels, **kw, **extra)
    # the JAX package refuses the first three alike
    from repro.core.populations.hetero import HeteroClients as JHetero
    for archs, extra, _, match in cases[:3]:
        with pytest.raises(ValueError, match=match):
            JHetero(archs, pool, labels, rounds=1, **extra)


# ---------------------------------------------------------------------------
# each family's client: losses, logits and gradients

def _tokens(B=2, S=16, V=512, seed=3):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_client_matches_jax(arch):
    """``private_loss`` (with the MoE aux losses), ``public_ce_and_logits``
    (all B*S rows, no aux) and ``share_logits`` on JAX params, values and
    gradients: of the private loss, and of ce + <logits, G> for a random G
    (so every logit's gradient counts)."""
    jcm, cm = jget_client_model(arch), get_client_model(arch)
    jp = jcm.init(jax.random.PRNGKey(1))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    toks = _tokens()
    V = cm.n_classes
    # scaled so that the gradients stay O(1), where the tolerance is set
    G = (1e-3 * np.random.default_rng(4).standard_normal(
        (toks.size, V))).astype(np.float32)

    def jpub(p):
        ce, lg = jcm.public_ce_and_logits(p, jnp.asarray(toks), None, None)
        return ce + jnp.sum(lg * G), (ce, lg)
    (jl, jg) = jax.jit(jax.value_and_grad(
        lambda p: jcm.private_loss(p, jnp.asarray(toks), None, None)))(jp)
    (_, (jce, jlg)), jgp = jax.jit(jax.value_and_grad(jpub,
                                                      has_aux=True))(jp)
    jshare = jax.jit(jcm.share_logits)(jp, jnp.asarray(toks))

    t = torch.from_numpy(toks).long()
    from repro_torch.core.distributed import value_and_grad
    loss, _, grads = value_and_grad(
        lambda p: (lambda v: (v, None))(cm.private_loss(p, t, None, None,
                                                        impl="ref")),
        params)
    _close(loss, jl)
    _trees_close(grads, jg)

    def pub(p):
        ce, lg = cm.public_ce_and_logits(p, t, None, None, impl="ref")
        return ce + torch.sum(lg * torch.from_numpy(G)), (ce.detach(),
                                                           lg.detach())
    _, (ce, lg), gp = value_and_grad(pub, params)
    assert lg.shape == (toks.size, V)
    _close(ce, jce)
    _close(lg, jlg)
    _trees_close(gp, jgp)
    _close(cm.share_logits(params, t, impl="ref"), jshare)
    assert not any(x.requires_grad for x in tree_leaves(params))


def test_vision_client_matches_jax_without_dropout():
    """The VisionNet client at dropout 0 (JAX: no key, no dropout): BCE and
    its gradient, the public BCE and the Bernoulli lift, whose softmax is
    exactly [1-p, p]."""
    jcfg = jvn_reduced().replace(dropout_rate=0.0)
    cfg = vn_reduced().replace(dropout_rate=0.0)
    from repro.models import _vision_client as jvision
    from repro_torch.models import _vision_client
    jcm, cm = jvision("visionnet", jcfg), _vision_client("visionnet", cfg)
    assert get_client_model(cfg)[:4] == cm[:4] == \
        ("visionnet", "vision", "vision", cfg)
    jp = jcm.init(jax.random.PRNGKey(2))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0, 1, (4, cfg.image_size, cfg.image_size, 3)) \
        .astype(np.float32)
    labs = np.array([0, 1, 1, 0], np.int32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jcm.private_loss(
        p, jnp.asarray(imgs), jnp.asarray(labs), None)))(jp)
    jce, jlg = jax.jit(lambda p: jcm.public_ce_and_logits(
        p, jnp.asarray(imgs), jnp.asarray(labs), None))(jp)
    from repro_torch.core.distributed import value_and_grad
    x, y = torch.from_numpy(imgs), torch.from_numpy(labs)
    gen = torch.Generator().manual_seed(0)     # rate 0: every mask keeps
    loss, _, grads = value_and_grad(
        lambda p: (cm.private_loss(p, x, y, gen, impl="ref"), None), params)
    _close(loss, jl)
    _trees_close(grads, jg)
    ce, lg = cm.public_ce_and_logits(params, x, y, gen, impl="ref")
    _close(ce, jce)
    _close(lg, jlg)
    share = cm.share_logits(params, x, impl="ref")
    _close(share, jax.jit(jcm.share_logits)(jp, jnp.asarray(imgs)))
    from repro_torch.models.visionnet import visionnet_forward
    from repro_torch.core.stacking import expand_stack
    p = visionnet_forward(expand_stack(params), cfg, x)[0]
    soft = torch.softmax(share, dim=-1)
    _close(soft[:, 1], p)
    _close(soft[:, 0], 1 - p)


# ---------------------------------------------------------------------------
# Eq. 2 against the received predictions

@pytest.mark.parametrize("J,T,V", [(1, 1.0, 300), (2, 1.0, 517),
                                   (3, 1.7, 256)])
def test_kl_to_received_matches_jax_and_the_pair_call(J, T, V):
    """``kl_to_received`` at "ref" against the JAX function, value and
    gradient; and equal on the CPU to the call its "cuda" impl makes:
    ``ops.mutual_kl_pair(live[None], received, 1/J)[0]``."""
    rng = np.random.default_rng(J)
    live = (2 * rng.standard_normal((7, V))).astype(np.float32)
    rec = (2 * rng.standard_normal((J, 7, V))).astype(np.float32)
    gbar = rng.standard_normal(7).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jmutual.kl_to_received(
        a, jnp.asarray(rec), T), jnp.asarray(live))
    (dwant,) = vjp(jnp.asarray(gbar))
    lt = torch.from_numpy(live).requires_grad_(True)
    got = mutual.kl_to_received(lt, torch.from_numpy(rec), T, impl="ref")
    got.backward(torch.from_numpy(gbar))
    _close(got, want)
    _close(lt.grad, dwant)
    lt2 = torch.from_numpy(live).requires_grad_(True)
    w = torch.full((1, J), 1.0 / J)
    pair = ops.mutual_kl_pair(lt2[None], torch.from_numpy(rec), w,
                              temperature=T, impl="ref")[0]
    pair.backward(torch.from_numpy(gbar))
    _close(pair, got)
    _close(lt2.grad, lt.grad)
    with pytest.raises(ValueError, match="unknown kernel impl"):
        mutual.kl_to_received(lt, torch.from_numpy(rec), T, impl="pallas")


# ---------------------------------------------------------------------------
# the pool and the accounting

@pytest.mark.parametrize("n,seq,vocab,seed,domains", [
    (60, 16, 512, 0, 4), (37, 9, 101, 3, 3), (8, 513, 151_936, 1, 4)])
def test_make_lm_pool_and_comm_bytes_byte_for_byte(n, seq, vocab, seed,
                                                   domains):
    data, labels = make_lm_pool(n, seq, vocab, seed=seed, n_domains=domains)
    jdata, jlabels = jmake_lm_pool(n, seq, vocab, seed=seed,
                                   n_domains=domains)
    assert data.dtype == jdata.dtype and labels.dtype == jlabels.dtype
    assert np.array_equal(data, jdata) and np.array_equal(labels, jlabels)
    for args in ((3, 1024, 151_936, 1), (2, 48, 512, 2, 2), (5, 7, 2, 3)):
        assert comm_bytes_per_round(*args) == jcomm_bytes(*args)
