"""The port's serving engine (``repro_torch.serve``) against the JAX
``ServeEngine`` at reduced qwen3-4b (fp32, K=3 clients), plus the port's
own invariants and its import and device policy.

The JAX engine runs under ``use_impl("interpret")``, so its prefill goes
through the interpreted Pallas flash kernel.  Tolerance: logits atol/rtol
2e-4 (the JAX suite's pin for teacher-forced decode logits); greedy tokens
must be equal up to the first step where JAX's top-1/top-2 margin is below
that tolerance (a near-tie may flip either way).
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_reduced as jget_reduced
from repro.kernels import ops as jops
from repro.models import transformer as jtfm
from repro.serve import ServeEngine as JaxEngine
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as ttfm
from repro_torch.serve import (ServeEngine, combine_logits,
                               load_serving_params, write_slot)
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ATOL = 2e-4
K, S0, G = 3, 130, 6


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = jget_reduced("qwen3-4b")
    params = jax.vmap(lambda k: jtfm.init_model(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S0)).astype(np.int32)
    return cfg, get_reduced("qwen3-4b"), params, tparams, prompts


def _engines(mode, **kw):
    cfg, tcfg, params, tparams, _ = _setup()
    if mode == "single":
        params = jax.tree.map(lambda t: t[0], params)
        tparams = tree_map(lambda t: t[0], tparams)
    kw = dict(mode=mode, slots=2, max_seq=160, **kw)
    return (JaxEngine(cfg, params, **kw),
            ServeEngine(tcfg, tparams, device="cpu", **kw))


def _agree_until_near_tie(want_toks, got_toks, want_lg):
    """Tokens equal up to the first step whose top-2 margin < ATOL."""
    top2 = -np.sort(-want_lg, axis=-1)[..., :2]
    margin = top2[..., 0] - top2[..., 1]            # (B, G) for emissions 1..
    for b in range(want_toks.shape[0]):
        for t in range(want_toks.shape[1]):
            if t > 0 and margin[b, t - 1] < ATOL:
                break
            assert want_toks[b, t] == got_toks[b, t], (b, t)


@pytest.mark.parametrize("mode,window", [("single", None),
                                         ("average", None),
                                         ("route", None),
                                         ("average", 40)])
def test_generate_matches_jax_engine(mode, window):
    """With window 40 the prompt is longer than the ring: prefill rolls its
    tail in and decode wraps around it."""
    _, _, _, _, prompts = _setup()
    jeng, teng = _engines(mode, window=window)
    with jops.use_impl("interpret"):
        want_toks, want_lg = jeng.generate(prompts, G, return_logits=True)
    got_toks, got_lg = teng.generate(prompts, G, return_logits=True)
    np.testing.assert_allclose(got_lg, np.asarray(want_lg), atol=ATOL,
                               rtol=ATOL)
    _agree_until_near_tie(np.asarray(want_toks), got_toks,
                          np.asarray(want_lg))
    assert teng.dispatch_counts() == jeng.dispatch_counts()


def test_continuous_batching_matches_jax_engine():
    cfg, _, _, _, _ = _setup()
    jeng, teng = _engines("average", chunk=3)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab_size, (3 + 37 * i,)).astype(np.int32),
             4 + i % 3) for i in range(5)]     # 5 requests > 2 slots
    with jops.use_impl("interpret"):
        for p, n in reqs:
            jeng.submit(p, n)
        want = jeng.run()
    for p, n in reqs:
        teng.submit(p, n)
    got = teng.run()
    assert set(got) == set(want) == set(range(5))
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), rid
    assert teng.dispatch_counts() == jeng.dispatch_counts()
    assert teng.scheduler.idle


def test_continuous_batching_matches_isolated_generate():
    """Mid-flight admission and retirement do not perturb neighbours."""
    cfg, tcfg, _, tparams, _ = _setup()
    one = tree_map(lambda t: t[1], tparams)
    eng = ServeEngine(tcfg, one, mode="single", slots=2, max_seq=32,
                      chunk=3, device="cpu")
    solo = ServeEngine(tcfg, one, mode="single", slots=1, max_seq=32,
                       device="cpu")
    rng = np.random.default_rng(0)
    want = {}
    for i in range(5):
        p = rng.integers(0, cfg.vocab_size, (3 + i % 3,)).astype(np.int32)
        n = 4 + i % 4
        want[eng.submit(p, n)] = solo.generate(p[None], n)[0]
    got = eng.run()
    for rid, w in want.items():
        assert np.array_equal(got[rid], w), rid


def test_chunk_size_invariant():
    cfg, tcfg, _, tparams, _ = _setup()
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (2 + i,)).astype(np.int32),
             3 + i) for i in range(3)]
    outs = []
    for chunk in (2, 5):
        eng = ServeEngine(tcfg, tparams, mode="route", slots=2, max_seq=32,
                          chunk=chunk, device="cpu")
        rids = [eng.submit(p, n) for p, n in reqs]
        done = eng.run()
        outs.append([done[r] for r in rids])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


def test_dispatch_count_constant_in_gen_len():
    _, tcfg, _, tparams, prompts = _setup()
    for mode, n in (("average", 3), ("route", 4)):
        counts = []
        for gen_len in (2, 9):
            eng = ServeEngine(tcfg, tparams, mode=mode, slots=2,
                              max_seq=160, device="cpu")
            eng.generate(prompts, gen_len)
            counts.append(len(eng.dispatch_log))
        assert counts == [n, n]


def test_generate_runs_no_step_it_does_not_emit(monkeypatch):
    """Without ``return_logits`` the decode skips the forward whose sample
    no one emits; the tokens are the same either way (exact: the same ops
    on the same inputs)."""
    _, tcfg, _, tparams, prompts = _setup()
    eng = ServeEngine(tcfg, tparams, mode="average", slots=2, max_seq=160,
                      device="cpu")
    steps = []
    raw = eng._raw_decode
    monkeypatch.setattr(eng, "_raw_decode",
                        lambda *a: steps.append(1) or raw(*a))
    toks = eng.generate(prompts, 4)
    assert len(steps) == 3
    want, _ = eng.generate(prompts, 4, return_logits=True)
    assert len(steps) == 3 + 4 and np.array_equal(toks, want)
    assert eng.generate(prompts, 1).shape == (2, 1) and len(steps) == 7


def test_sampling_deterministic_and_top_k_respected():
    _, tcfg, _, tparams, prompts = _setup()
    kw = dict(mode="average", slots=2, max_seq=160, temperature=0.8,
              top_k=4, device="cpu")
    a = ServeEngine(tcfg, tparams, seed=7, **kw).generate(prompts, 6)
    b = ServeEngine(tcfg, tparams, seed=7, **kw).generate(prompts, 6)
    c = ServeEngine(tcfg, tparams, seed=8, **kw).generate(prompts, 6)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    toks, lg = ServeEngine(tcfg, tparams, seed=7, **kw).generate(
        prompts, 6, return_logits=True)
    order = np.argsort(-lg[:, :-1], axis=-1)[..., :4]
    assert (toks[:, 1:, None] == order).any(-1).all()


def test_oracle_step_matches_engine_decode():
    """The one-step reference equals the engine's fused decode, bitwise."""
    _, tcfg, _, tparams, prompts = _setup()
    eng = ServeEngine(tcfg, tparams, mode="average", slots=2, max_seq=160,
                      device="cpu")
    toks, lg = eng.generate(prompts, 3, return_logits=True)
    ids = torch.as_tensor(prompts, dtype=torch.long)
    logits, cache = ttfm.prefill_clients(tparams, tcfg, ids, max_seq=160,
                                         impl="ref")
    tok = combine_logits(logits, "average").argmax(-1)[:, None]
    for t in range(3):
        assert np.array_equal(tok[:, 0].numpy(), toks[:, t])
        lo, cache = eng.oracle_step(tok, cache, S0 + t)
        assert np.array_equal(lo.numpy(), lg[:, t])
        tok = lo.argmax(-1)[:, None]


def test_prompt_ce_and_router_match_jax():
    from repro.serve import make_router as jmake_router
    from repro.serve import prompt_ce as jprompt_ce
    from repro_torch.serve import make_router, prompt_ce
    cfg, tcfg, params, tparams, prompts = _setup()
    one = jax.tree.map(lambda t: t[2], params)
    want = jprompt_ce(one, cfg, jnp.asarray(prompts))
    got = prompt_ce(tree_map(lambda t: t[2], tparams), tcfg,
                    torch.as_tensor(prompts, dtype=torch.long), impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    widx, wce = jmake_router(cfg)(params, jnp.asarray(prompts))
    idx, ce = make_router(tcfg, "ref")(
        tparams, torch.as_tensor(prompts, dtype=torch.long))
    np.testing.assert_allclose(ce.numpy(), np.asarray(wce), atol=1e-5,
                               rtol=1e-5)
    assert np.array_equal(idx.numpy(), np.asarray(widx))


def test_combine_logits_and_in_place_slot_write():
    lo = torch.arange(24, dtype=torch.float32).reshape(3, 2, 4)
    assert torch.equal(combine_logits(lo, "average"), lo.mean(0))
    picked = combine_logits(lo, "route", torch.tensor([2, 0]))
    assert torch.equal(picked, torch.stack([lo[2, 0], lo[0, 1]]))
    with pytest.raises(ValueError):
        combine_logits(lo, "mean")
    arena = {"a": torch.zeros(2, 5, 3, 4)}
    leaf = arena["a"]
    write_slot(arena, {"a": torch.ones(2, 5, 1, 4)}, 1, axis=2)
    assert arena["a"] is leaf                     # written in place
    assert leaf[:, :, 1].eq(1).all() and leaf[:, :, [0, 2]].eq(0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_serving_params_from_jax_checkpoint(tmp_path, dtype):
    """A JAX-written population file (export_for_serving schema) loads in
    the port and serves the same logits as the JAX engine on it."""
    cfg, _, params, _, prompts = _setup()
    params = jax.tree.map(lambda t: t.astype(dtype), params)
    path = str(tmp_path / "fed.npz")
    jckpt.save(path, {"client_params": params},
               {"engine": "lm", "arch": cfg.name, "n_clients": K})
    tcfg, tparams, n = load_serving_params(path, device="cpu")
    assert n == K and tcfg == get_reduced("qwen3-4b")
    want = jax.tree.map(lambda t: np.asarray(t.astype(jnp.float32)), params)
    got = tree_map(lambda t: t.float().numpy(), tparams)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(a, b)
    kw = dict(mode="average", slots=1, max_seq=140)
    jeng = JaxEngine.from_checkpoint(path, **kw)
    teng = ServeEngine.from_checkpoint(path, device="cpu", **kw)
    assert teng.n_checkpoint_clients == K
    with jops.use_impl("interpret"):
        want_toks, want_lg = jeng.generate(prompts[:1], 4, return_logits=True)
    got_toks, got_lg = teng.generate(prompts[:1], 4, return_logits=True)
    np.testing.assert_allclose(got_lg, np.asarray(want_lg, np.float32),
                               atol=ATOL, rtol=ATOL)
    _agree_until_near_tie(np.asarray(want_toks), got_toks,
                          np.asarray(want_lg, np.float32))


def test_serve_cli_from_jax_checkpoint(tmp_path, capsys):
    cfg, _, params, _, _ = _setup()
    path = str(tmp_path / "fed.npz")
    jckpt.save(path, {"client_params": params},
               {"engine": "lm", "arch": cfg.name, "n_clients": K})
    assert serve_cli.main(["--ckpt", path, "--device", "cpu", "--ensemble",
                           "route", "--batch", "1", "--prompt-len", "5",
                           "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert f"clients={K} mode=route" in out and "generated (1, 3)" in out


def test_load_serving_params_rejects_unservable(tmp_path):
    bad = str(tmp_path / "hetero.npz")
    jckpt.save(bad, {"x": np.zeros(2)}, {"engine": "hetero",
                                         "arch": "qwen3-4b"})
    with pytest.raises(ValueError, match="not servable"):
        load_serving_params(bad, device="cpu")
    other = str(tmp_path / "other.npz")      # an arch of neither registry
    jckpt.save(other, {"x": np.zeros(2)}, {"arch": "llama-2-7b"})
    with pytest.raises(ValueError, match="not in"):
        load_serving_params(other, device="cpu")


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    _, tcfg, _, tparams, _ = _setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tcfg, tparams, mode="average")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttfm.init_model(0, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main([])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ServeEngine(tcfg, tparams, mode="average", impl="cuda",
                    device="cpu")


def test_serve_cli_on_cpu(capsys):
    assert serve_cli.main(["--device", "cpu", "--requests", "3", "--slots",
                           "2", "--gen", "4", "--prompt-len", "6"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "impl=ref" in out
    # the default arch is the JAX CLI's (repro/launch/serve.py)
    assert "arch=mamba2-780m random-init" in out


# the training, SSM, vision, MoE, prefix-frontend, hetero and mesh slices'
# modules, named so that the walk below cannot miss one
TRAINING_MODULES = (
    "repro_torch.api", "repro_torch.core.api", "repro_torch.core.distributed",
    "repro_torch.core.mutual", "repro_torch.core.stacking",
    "repro_torch.core.strategies.base", "repro_torch.core.strategies.dml",
    "repro_torch.core.populations.base", "repro_torch.core.populations.lm",
    "repro_torch.data.federated", "repro_torch.kernels.kl_mutual",
    "repro_torch.optim", "repro_torch.launch.train",
    "repro_torch.configs.mamba2_780m", "repro_torch.kernels.ssd_scan",
    "repro_torch.models.ssm", "repro_torch.kernels.sparse_kl",
    "repro_torch.core.fedavg", "repro_torch.core.async_fl",
    "repro_torch.core.strategies.weights", "repro_torch.configs.visionnet",
    "repro_torch.models.visionnet", "repro_torch.core.populations.vision",
    "repro_torch.launch.visionnet", "repro_torch.data.synthetic",
    "repro_torch.models.moe", "repro_torch.configs.qwen2_moe_a2_7b",
    "repro_torch.configs.dbrx_132b",
    "repro_torch.configs.jamba_1_5_large_398b",
    "repro_torch.configs.qwen3_8b", "repro_torch.configs.minitron_4b",
    "repro_torch.configs.qwen1_5_110b",
    "repro_torch.configs.llava_next_mistral_7b",
    "repro_torch.configs.musicgen_medium", "repro_torch.models",
    "repro_torch.core.populations.hetero", "repro_torch.launch.steps",
    "repro_torch.launch.serve", "repro_torch.launch.hetero",
    "repro_torch.configs.base", "repro_torch.privacy",
    "repro_torch.privacy.dp", "repro_torch.privacy.accountant",
    "repro_torch.privacy.attacks", "repro_torch.core.strategies.dp",
    "repro_torch.core.strategies.robust", "repro_torch.sharding",
    "repro_torch.sharding.local",
    "repro_torch.launch.mesh", "repro_torch.launch.specs",
    "repro_torch.launch.dryrun", "repro_torch.analysis",
    "repro_torch.analysis.roofline", "repro_torch.launch.quickstart",
    "repro_torch.launch.serve_lm", "repro_torch.core.federated",
    "repro_torch.core.hetero")


def test_port_imports_no_jax_and_no_repro():
    """Every module of the port (the training slice's by name), and
    chip_smoke.py, import without JAX or the JAX package (run in a fresh
    interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        f"missing = sorted(set({TRAINING_MODULES!r}) - set(sys.modules))\n"
        "assert not missing, missing\n"
        "print(sum(m.startswith('repro_torch') for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20 + len(TRAINING_MODULES)
