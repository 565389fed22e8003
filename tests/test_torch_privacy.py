"""The port's privacy and robustness functions against the JAX package on
the CPU: the Renyi accountant and ``calibrate_noise`` (the same floats,
states crossing both ways), the DP payload transforms given JAX's draw
(the sigma = 0 gate returning the payload itself), the port's own
``gaussian`` draws, the robust Eq.-2 combiners for J = 2..5 senders with
masked rows (the even-J median is the mean of the two middle values, not
``torch.median``'s lower one), ``kl_to_robust_received`` and its gradient,
and the strategies' knobs, registry and checkpoint schema.

Inputs come from numpy with a seed.  Tolerances, fp32: single calls atol
1e-5 (the same math, summed in another order); the accountant exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mutual as jmutual
from repro.core.strategies import DPDML as JDPDML
from repro.privacy import accountant as jacc
from repro.privacy import dp as jdp
from repro_torch.api import (DML, DPDML, STRATEGIES, MedianDML, TrimmedDML,
                             get_strategy)
from repro_torch.core import mutual
from repro_torch.privacy import accountant, dp

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want, **kw):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **{**TOL, **kw})


def _jax_noise(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(
        key, shape, jnp.float32)))


# ---------------------------------------------------------------------------
# the accountant

@pytest.mark.parametrize("sigma", [0.3, 1.0, 2.7])
def test_accountant_and_calibration_give_jax_floats(sigma):
    for delta in (1e-5, 1e-3, 0.2):
        assert accountant.gaussian_epsilon(sigma, delta) == \
            jacc.gaussian_epsilon(sigma, delta)
        a, b = accountant.RDPAccountant(), jacc.RDPAccountant()
        for n in (1, 3, 10, 0):
            a.step(sigma, releases=n)
            b.step(sigma, releases=n)
            a.step(2 * sigma, releases=1)
            b.step(2 * sigma, releases=1)
            assert a.epsilon(delta) == b.epsilon(delta)
            assert a.best_alpha(delta) == b.best_alpha(delta)
            assert (a.rdp_coeff, a.releases) == (b.rdp_coeff, b.releases)
        assert a.state() == b.state()
        for releases in (1, 4, 50):
            for eps in (0.5, 4.0):
                assert accountant.calibrate_noise(eps, delta, releases) == \
                    jacc.calibrate_noise(eps, delta, releases)
    assert accountant.gaussian_epsilon(0.0, 1e-5) == math.inf
    assert accountant.RDPAccountant().epsilon(1e-5) == 0.0
    for bad in (lambda: accountant.gaussian_epsilon(1.0, 1.5),
                lambda: accountant.RDPAccountant().step(0.0),
                lambda: accountant.calibrate_noise(0.0, 1e-5, 3),
                lambda: accountant.calibrate_noise(1.0, 1e-5, 0)):
        with pytest.raises(ValueError):
            bad()


def test_accountant_states_cross_both_ways():
    a, b = accountant.RDPAccountant(), jacc.RDPAccountant()
    a.step(1.3, releases=4)
    a.step(0.7, releases=2)
    b.load_state(a.state())
    assert b.epsilon(1e-5) == a.epsilon(1e-5) and b.state() == a.state()
    b.step(2.0, releases=3)
    a2 = accountant.RDPAccountant()
    a2.load_state(b.state())
    assert a2.epsilon(1e-6) == b.epsilon(1e-6) and a2.state() == b.state()


# ---------------------------------------------------------------------------
# the payload transforms

@pytest.mark.parametrize("center", [None, 0.5])
@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clipping", "inside"])
def test_dp_noise_payload_matches_jax_given_its_draw(center, clip):
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 1.0, (3, 5, 7)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jdp.dp_noise_payload(jnp.asarray(x), clip, 1.3, key, center)
    got = dp.dp_noise_payload(torch.from_numpy(x), clip, 1.3,
                              _jax_noise(key, x.shape), center)
    _close(got, want)
    _close(dp.clip_payload(torch.from_numpy(x), clip),
           jdp.clip_payload(jnp.asarray(x), clip))
    probs = jdp.dp_probs_payload(jnp.asarray(x), clip, 1.3, key)
    _close(dp.dp_probs_payload(torch.from_numpy(x), clip, 1.3,
                               _jax_noise(key, x.shape)), probs)


def test_dp_gate_and_dtype():
    """sigma <= 0 returns the payload itself (JAX: bitwise the same
    values); a bf16 payload comes back bf16, within bf16 rounding of the
    JAX package's."""
    x = torch.rand(2, 3, 4)
    for sigma in (0.0, -1.0):
        assert dp.dp_noise_payload(x, 1.0, sigma, None) is x
        assert dp.dp_probs_payload(x, 1.0, sigma, None) is x
        want = jdp.dp_probs_payload(jnp.asarray(x.numpy()), 1.0, sigma,
                                    jax.random.PRNGKey(0))
        assert np.array_equal(np.asarray(want), x.numpy())
    rng = np.random.default_rng(5)
    y = (4 * rng.standard_normal((3, 16, 33))).astype(np.float32)
    key = jax.random.PRNGKey(2)
    xb = torch.from_numpy(y).to(torch.bfloat16)
    got = dp.dp_noise_payload(xb, 10.0, 0.8, _jax_noise(key, y.shape))
    want = jdp.dp_noise_payload(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                10.0, 0.8, key)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_gaussian_is_the_ports_own_standard_normal():
    a = dp.gaussian(np.array([0, 7], np.uint32), (100_000,), "cpu")
    assert a.dtype == torch.float32 and a.shape == (100_000,)
    assert abs(float(a.mean())) < 0.03 and abs(float(a.std()) - 1) < 0.03
    assert torch.equal(a, dp.gaussian([0, 7], (100_000,), "cpu"))
    for other in ([0, 8], [1, 7], [7, 0]):
        b = dp.gaussian(np.array(other, np.uint32), (100_000,), "cpu")
        assert not torch.equal(a, b)
    assert dp.gaussian([3, 4], (2, 3, 5), "cpu").shape == (2, 3, 5)


# ---------------------------------------------------------------------------
# the robust combiners

def _recv_mask(K, absent):
    pm = np.ones(K, np.float32)
    pm[list(absent)] = 0.0
    return pm, pm[None, :] * (1.0 - np.eye(K, dtype=np.float32))


@pytest.mark.parametrize("J", [2, 3, 4, 5])
def test_robust_weighted_and_bernoulli_targets_match_jax(J):
    """K = J + 1 senders, each receiver aggregating the others, with and
    without absent senders; trim 1 and trim 2 (the fallback to the mean
    where n - 2 trim < 1); both modes."""
    K = J + 1
    rng = np.random.default_rng(J)
    shared = rng.uniform(0.0, 1.0, (K, 9)).astype(np.float32)
    for absent in ((), (1,), (0, K - 1)):
        pm, recv = _recv_mask(K, absent)
        for mode in ("trimmed", "median"):
            for trim in (1, 2):
                _close(mutual.robust_weighted_target(
                    torch.from_numpy(shared), torch.from_numpy(recv), mode,
                    trim),
                    jmutual.robust_weighted_target(jnp.asarray(shared), recv,
                                                   mode, trim))
                for part in (None, pm):
                    _close(mutual.robust_bernoulli_target(
                        torch.from_numpy(shared), part, mode, trim),
                        jmutual.robust_bernoulli_target(
                            jnp.asarray(shared), part, mode, trim))
    with pytest.raises(ValueError, match="robust mode"):
        mutual.robust_weighted_target(torch.from_numpy(shared),
                                      torch.ones(K, K), "mean")
    live = rng.uniform(0.0, 1.0, (K, 9)).astype(np.float32)
    _close(mutual.bernoulli_kl_to_target(torch.from_numpy(live),
                                         torch.from_numpy(shared)),
           jmutual.bernoulli_kl_to_target(jnp.asarray(live),
                                          jnp.asarray(shared)))


@pytest.mark.parametrize("mode", ["trimmed", "median"])
@pytest.mark.parametrize("J", [2, 3, 4, 5])
def test_robust_categorical_target_matches_jax(J, mode):
    rng = np.random.default_rng(10 + J)
    rec = (2 * rng.standard_normal((J, 6, 11))).astype(np.float32)
    for trim in (1, 2):
        got = mutual.robust_categorical_target(torch.from_numpy(rec), mode,
                                               trim)
        _close(got, jmutual.robust_categorical_target(jnp.asarray(rec), mode,
                                                      trim))
    if mode == "median" and J % 2 == 0:
        # the even-J median is the mean of the two middle values: the
        # lower one (torch.median) would differ
        lower = torch.median(torch.softmax(torch.from_numpy(rec), -1),
                             dim=0).values
        lower = lower / lower.sum(-1, keepdim=True)
        assert not torch.allclose(got, lower, atol=1e-4)
    with pytest.raises(ValueError, match="robust mode"):
        mutual.robust_categorical_target(torch.from_numpy(rec), "mean")


def test_robust_categorical_target_in_row_blocks(monkeypatch):
    """Blocks of rows give the one-block result bit for bit."""
    rng = np.random.default_rng(4)
    rec = torch.from_numpy((2 * rng.standard_normal((4, 13, 17)))
                           .astype(np.float32))
    whole = {m: mutual.robust_categorical_target(rec, m, 1)
             for m in ("trimmed", "median")}
    monkeypatch.setattr(mutual, "_TARGET_BLOCK", 3 * 4 * 17)   # 3 rows
    for m, want in whole.items():
        assert torch.equal(mutual.robust_categorical_target(rec, m, 1), want)


@pytest.mark.parametrize("mode", ["trimmed", "median"])
@pytest.mark.parametrize("J", [3, 4])
def test_kl_to_robust_received_and_its_gradient(J, mode):
    rng = np.random.default_rng(20 + J)
    live = (2 * rng.standard_normal((7, 19))).astype(np.float32)
    rec = (2 * rng.standard_normal((J, 7, 19))).astype(np.float32)
    gbar = rng.standard_normal(7).astype(np.float32)
    for T in (1.0, 2.0):
        want, vjp = jax.vjp(lambda a: jmutual.kl_to_robust_received(
            a, jnp.asarray(rec), mode, 1, T), jnp.asarray(live))
        (dwant,) = vjp(jnp.asarray(gbar))
        lt = torch.from_numpy(live).requires_grad_(True)
        rt = torch.from_numpy(rec).requires_grad_(True)
        got = mutual.kl_to_robust_received(lt, rt, mode, 1, T)
        got.backward(torch.from_numpy(gbar))
        _close(got, want)
        _close(lt.grad, dwant)
        assert rt.grad is None              # the target is data


# ---------------------------------------------------------------------------
# the strategies

def test_strategies_registered_with_jax_knobs_and_checks():
    assert {"dp-dml", "trimmed-dml", "median-dml"} <= set(STRATEGIES)
    s = get_strategy("dp-dml", kl_weight=2.0, dp_noise_multiplier=3.0,
                     trim=4)
    assert isinstance(s, DPDML)
    assert (s.kl_weight, s.dp_noise_multiplier) == (2.0, 3.0)
    t = get_strategy("trimmed-dml", trim=2, dp_noise_multiplier=9.0)
    assert isinstance(t, TrimmedDML) and t.trim == 2
    m = get_strategy("median-dml")
    assert isinstance(m, MedianDML) and m.robust_mode == "median"
    assert isinstance(get_strategy("dml", dp_noise_multiplier=1.0), DML)
    for make, jmake in ((lambda: DPDML(dp_noise_multiplier=0.0),
                         lambda: JDPDML(dp_noise_multiplier=0.0)),
                        (lambda: DPDML(dp_clip=0.0),
                         lambda: JDPDML(dp_clip=0.0))):
        with pytest.raises(ValueError) as got:
            make()
        with pytest.raises(ValueError) as want:
            jmake()
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="trim must be >= 0"):
        TrimmedDML(trim=-1)


def test_dpdml_key_chain_and_state_schema():
    """The key starts at the JAX package's PRNGKey words, advances once a
    round into (E, 2) epoch keys, and the state has JAX's schema."""
    for seed in (0, 5):
        s, js = DPDML(dp_seed=seed, mutual_epochs=3), \
            JDPDML(dp_seed=seed, mutual_epochs=3)
        assert s.state_dict()["noise_key"] == js.state_dict()["noise_key"]
        assert sorted(s.state_dict()) == sorted(js.state_dict())
        k0 = s._noise_key.copy()
        key, keys = s._advance()
        assert keys.shape == (3, 2) and keys.dtype == np.uint32
        assert np.array_equal(s._noise_key, k0)         # pure
        assert np.array_equal(s._advance()[1], keys)
        assert not np.array_equal(key, k0)
    s = DPDML(dp_noise_multiplier=1.5)
    s.accountant.step(1.5, releases=2)
    s._noise_key = np.array([3, 9], np.uint32)
    js = JDPDML(dp_noise_multiplier=1.5)
    js.load_state_dict(s.state_dict())
    assert js.epsilon() == s.epsilon()
    back = DPDML(dp_noise_multiplier=1.5)
    back.load_state_dict(js.state_dict())
    assert back.state_dict() == s.state_dict()
    with pytest.raises(ValueError, match="dp_noise_multiplier"):
        DPDML(dp_noise_multiplier=2.0).load_state_dict(s.state_dict())
