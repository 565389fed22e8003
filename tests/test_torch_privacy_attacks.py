"""The port's attack probes (``repro_torch.privacy.attacks``) against the
JAX package's on the CPU: the numpy probes equal; per-example losses,
the weight-upload MIA, the example gradient and the dense features of a
VisionNet whose params cross by ``interop``; the closed-form feature leak
of a gradient; the Adam loop; the surrogate distillation from the same
init (the JAX package's ``init_visionnet`` patched in this test to return
the shared params); the gradient inversion fitting its gradient (a double
backward through the grouped convolutions and max-pools), and the payload
baseline staying at chance.

Tolerances, fp32: single calls atol 1e-5; the loops (Adam, 40 momentum
steps) atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.privacy.attacks as jattacks
from repro.configs.visionnet import reduced as jreduced
from repro.models.visionnet import init_visionnet as jinit
from repro_torch import interop
from repro_torch.configs.visionnet import reduced
from repro_torch.privacy import attacks
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
CFG = reduced().replace(image_size=16)
JCFG = jreduced().replace(image_size=16)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=atol)


def _trees_close(got, want, atol=1e-5):
    from repro_torch.checkpoint import flatten
    got = flatten(got)
    want = flatten(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], atol)


@pytest.fixture(scope="module")
def params():
    """One VisionNet client's params from the JAX package: (JAX, port)."""
    jp = jinit(jax.random.PRNGKey(3), JCFG)
    return jp, interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


@pytest.fixture(scope="module")
def pool():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 16, 16, 3)).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.float32)
    return x, y


def test_numpy_probes_equal_jaxs():
    rng = np.random.default_rng(1)
    for n, m in ((50, 70), (3, 1)):
        a, b = rng.normal(size=n), rng.normal(0.5, 1, size=m)
        assert attacks.mia_advantage(a, b) == jattacks.mia_advantage(a, b)
    assert attacks.mia_advantage([5.0, 6.0], [1.0, 2.0]) == 1.0
    with pytest.raises(ValueError):
        attacks.mia_advantage([], [1.0])
    p = rng.uniform(0.0, 1.0, 64)
    y = (rng.random(64) > 0.5).astype(np.float32)
    assert np.array_equal(attacks.per_example_bce(p, y),
                          jattacks.per_example_bce(p, y))
    u, v = rng.normal(size=(2, 30))
    assert attacks.cosine_similarity(u, v) == \
        jattacks.cosine_similarity(u, v)
    assert attacks.reconstruction_error(u, v) == \
        jattacks.reconstruction_error(u, v)
    assert attacks.reconstruction_error(-3 * u + 7, u) < 1e-12
    images = rng.normal(size=(20, 4, 4, 3))
    log = [{"public": np.arange(5) + 3 * i,
            "payloads": rng.uniform(size=(2, 3, 5))} for i in range(2)]
    for got, want in zip(attacks.collect_client_payloads(log, images, 1),
                         jattacks.collect_client_payloads(log, images, 1)):
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="payload_log is empty"):
        attacks.collect_client_payloads([], images, 0)


def test_losses_mia_gradient_and_features_match_jax(params, pool):
    jp, p = params
    x, y = pool
    got = attacks.model_example_losses(p, CFG, x, y, batch=8)
    _close(got, jattacks.model_example_losses(jp, JCFG, x, y, batch=256))
    mem, non = np.arange(0, 20), np.arange(20, 37)
    assert abs(attacks.weight_upload_mia(p, CFG, x, y, mem, non)
               - jattacks.weight_upload_mia(jp, JCFG, x, y, mem, non)) \
        <= 1 / 17 + 1e-12
    g = attacks.example_gradient(p, CFG, x[:3], y[:3])
    _trees_close(g, jattacks.example_gradient(jp, JCFG, x[:3], y[:3]))
    h = attacks.dense_features(p, CFG, x)
    _close(h, jattacks.dense_features(jp, JCFG, x))


def test_features_from_grad_recovers_dense_features(params, pool):
    """One example's gradient hands over its penultimate representation:
    exactly, from the port's tree and from a one-client stack of it."""
    _, p = params
    x = pool[0][:1]
    g = attacks.example_gradient(p, CFG, x, np.array([1.0], np.float32))
    h_true = attacks.dense_features(p, CFG, x)[0].numpy()
    for grad in (g, {"head": {k: t[None] for k, t in g["head"].items()}}):
        h_rec = attacks.features_from_grad(grad)
        assert attacks.cosine_similarity(h_true, h_rec) > 0.999
        assert np.linalg.norm(h_rec - h_true) / np.linalg.norm(h_true) < 1e-4
    with pytest.raises(ValueError, match="grad_b_head"):
        attacks.features_from_grad({"head": {"w": np.zeros((7, 1)),
                                             "b": np.zeros((1,))}})


def test_adam_scan_matches_jax():
    rng = np.random.default_rng(2)
    c, w = rng.normal(size=(2, 5, 6)).astype(np.float32)
    w = np.abs(w) + 0.1
    x0 = rng.normal(size=(5, 6)).astype(np.float32)

    def jobj(x):
        return jnp.sum(w * (x - c) ** 2) + 0.1 * jnp.sum(x ** 4)

    ct, wt = torch.from_numpy(c), torch.from_numpy(w)

    def obj(x):
        return torch.sum(wt * (x - ct) ** 2) + 0.1 * torch.sum(x ** 4)

    want = jax.jit(lambda a: jattacks._adam_scan(jobj, a, 60, 0.05))(x0)
    got = attacks._adam_scan(obj, torch.from_numpy(x0), 60, 0.05)
    _close(got, want, atol=1e-4)


def test_distill_surrogate_matches_jax_from_the_same_init(params, pool,
                                                          monkeypatch):
    jp, p = params
    monkeypatch.setattr(jattacks, "init_visionnet", lambda key, cfg: jp)
    monkeypatch.setattr(attacks, "init_visionnet",
                        lambda key, cfg, device: p)
    x = pool[0][:16]
    probs = np.linspace(0.1, 0.9, 16).astype(np.float32)
    want = jattacks.distill_surrogate(JCFG, x, probs,
                                      jax.random.PRNGKey(0), steps=40)
    got = attacks.distill_surrogate(CFG, x, probs, 0, steps=40,
                                    device="cpu")
    _trees_close(got, want, atol=1e-4)
    # the probe on top: the surrogate's losses as JAX's
    _close(attacks.model_example_losses(got, CFG, *pool),
           jattacks.model_example_losses(want, JCFG, *pool), atol=1e-4)
    assert 0.0 <= attacks.payload_mia(CFG, x, probs, *pool, np.arange(10),
                                      np.arange(10, 37), 0, steps=5,
                                      device="cpu") <= 1.0


def test_gradient_inversion_fits_its_gradient(params, pool):
    """The optimisation attack solves its objective (the upload tightly
    constrains the adversary), through a double backward; the payload-only
    baseline stays at chance."""
    _, p = params
    x = torch.from_numpy(pool[0][:1])
    y = np.array([1.0], np.float32)
    g = attacks.example_gradient(p, CFG, x, y)
    x_rec, dist = attacks.gradient_inversion(p, CFG, g, (1, 16, 16, 3), y,
                                             5, steps=300)
    assert dist < 0.2 and x_rec.shape == (1, 16, 16, 3)
    assert all(t.grad is None for t in tree_leaves(p))
    x_pay = attacks.payload_reconstruction(CFG, p, np.array([0.7],
                                                            np.float32),
                                           (1, 16, 16, 3), 6, steps=100)
    assert attacks.reconstruction_error(x_pay, x.numpy()) > 1.0
