"""The port's dry-run on the meta device (``repro_torch.launch.specs``,
``repro_torch.launch.dryrun``) and the two examples
(``repro_torch.launch.quickstart``, ``repro_torch.launch.serve_lm``), held
against the JAX package's ``repro.launch.specs`` (``eval_shape``) and
``repro.launch.dryrun.model_flops_estimate``."""
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

# repro.launch.dryrun sets XLA_FLAGS (512 host devices) when imported; the
# rest of this worker's tests and subprocesses keep the value they had
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import dryrun as JD  # noqa: E402
from repro.launch import specs as JS  # noqa: E402

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro_torch.analysis import roofline as R  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import distributed as dml  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import quickstart, serve_lm  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SMALL_ARCHS = ("qwen3-4b", "dbrx-132b", "mamba2-780m",
               "jamba-1.5-large-398b")        # JAX's test_dryrun_small list
SMALL = {kind: ShapeConfig(f"small_{kind}", 16, 4, kind)
         for kind in ("train", "prefill", "decode")}


def _jax_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _torch_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        assert tree.is_meta, prefix
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).replace("torch.", ""))}
    out = {}
    for k, v in items:
        out.update(_torch_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _tree_bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# specs: the leaves' shapes and dtypes, every arch at full size

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax_eval_shape(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jparams, _ = JS.model_state_specs(jcfg)
    params = S.model_state_specs(cfg)
    assert _torch_leaves(params) == _jax_leaves(jparams)
    assert _torch_leaves(S.opt_state_specs(params)) == \
        _jax_leaves(JS.opt_state_specs(jparams))
    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        assert S.token_len(cfg, shape) == JS.token_len(jcfg, jshape)
        if shape.kind == "decode":
            assert _torch_leaves(S.cache_specs(cfg, shape)) == \
                _jax_leaves(JS.cache_specs(jcfg, jshape)[0])
            continue
        for n_clients in (0, 2):
            assert _torch_leaves(S.batch_inputs(cfg, shape, n_clients)) == \
                _jax_leaves(JS.batch_inputs(jcfg, jshape, n_clients)[0])
        assert _torch_leaves(S.public_inputs(cfg, shape, 4)) == \
            _jax_leaves(JS.public_inputs(jcfg, jshape, 4)[0])


def test_meta_init_keeps_the_card_rule():
    """``resolve_device`` takes "meta"; ``None`` still means CUDA and
    raises without a card; the CPU draws are unchanged by the meta path."""
    assert ops.resolve_device("meta") == torch.device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.resolve_device(None)
    cfg = get_reduced("mamba2-780m")
    meta = tfm.init_model(3, cfg, device="meta")
    a, b = (tfm.init_model(3, cfg, device="cpu") for _ in range(2))
    assert all(x.is_meta for x in tree_leaves(meta))
    for x, y, m in zip(tree_leaves(a), tree_leaves(b), tree_leaves(meta)):
        assert torch.equal(x, y) and x.shape == m.shape and x.dtype == m.dtype


# ---------------------------------------------------------------------------
# model FLOPs: JAX's formula, copied

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_matches_jax(arch):
    for name in SHAPES:
        for method in D.METHODS:
            assert D.model_flops_estimate(get_config(arch), SHAPES[name],
                                          method) == \
                JD.model_flops_estimate(jax_config(arch), JAX_SHAPES[name],
                                        method), (name, method)


# ---------------------------------------------------------------------------
# the counter

def _forward(params, cfg, tokens):
    return tfm.forward_clients(params, cfg, tokens, remat=False, impl="ref")


def test_meta_forward_flops_match_cpu_and_analytic():
    """A forward of K = 2 reduced qwen3-4b clients: the meta count equals
    ``FlopCounterMode`` over the same forward on real CPU tensors, and the
    matmul count of the architecture."""
    cfg = get_reduced("qwen3-4b")
    K, B, Sq = 2, 2, 16
    meta = (tfm.init_model(0, cfg, n_clients=K, device="meta"),
            torch.zeros((B, Sq), dtype=torch.int32, device="meta"))
    with D.count() as c:
        out = _forward(meta[0], cfg, meta[1])
    params = tfm.init_model(0, cfg, n_clients=K, device="cpu")
    tokens = torch.zeros((B, Sq), dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        _forward(params, cfg, tokens)
    T, d, hd = B * Sq, cfg.d_model, cfg.head_dim_
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    layer = (2 * T * d * (H + 2 * Hkv) * hd      # qkv projection
             + 2 * T * H * hd * d                # output projection
             + 2 * 2 * B * H * Sq * Sq * hd      # scores and values, full
             + 3 * 2 * T * d * cfg.d_ff)         # SwiGLU
    analytic = K * (cfg.n_layers * layer + 2 * T * d * cfg.vocab_size)
    assert c.flops == fc.get_total_flops() == analytic
    assert c.argument_bytes == _tree_bytes(meta)
    assert c.output_bytes >= _tree_bytes(out) > 0 and c.bytes > 0


def test_train_step_bytes_and_flops():
    """A reduced qwen3-4b train step: ``argument_bytes`` are the params,
    the moments and the tokens; the FLOPs are a forward and a backward
    (twice the forward) plus the remat's second forward; the peak is the
    sum of its parts."""
    cfg = get_reduced("qwen3-4b")
    shape = SMALL["train"]
    fn, args = D.build_case(cfg, shape, "single", "standard")
    params, opt, tokens = args
    with D.count() as c:
        out = fn(*args)
    assert c.argument_bytes == _tree_bytes(params, opt, tokens)
    # the metrics on the meta device (the learning rate is a host scalar)
    assert c.output_bytes == _tree_bytes(
        [t for t in out[2].values() if t is not None and t.is_meta]) > 0
    assert c.peak_bytes == (c.argument_bytes + c.output_bytes
                            + c.temp_bytes) > c.argument_bytes
    with D.count() as f:
        tfm.loss_fn_clients(tfm.init_model(0, cfg, n_clients=1,
                                           device="meta"), cfg,
                            tokens[None], remat=False, impl="ref")
    # the head's gradient runs on the logits rows only; every other matmul
    # runs three times (forward, its remat, two gradients minus the
    # embedding's gather)
    assert 3 * f.flops < c.flops < 4 * f.flops


def test_count_refuses_real_tensors():
    with pytest.raises(RuntimeError, match="meta device"):
        with D.count():
            torch.ones(3) + torch.ones(3)
    with D.count() as c:                  # a 0-d host scalar is admitted,
        torch.empty(3, device="meta") * torch.tensor(2.0)
        torch.empty((0,), requires_grad=True)   # and an empty tensor
    assert c.flops == 0
    with pytest.raises(RuntimeError, match="meta device"):
        with D.count():
            torch.empty((1,))


# ---------------------------------------------------------------------------
# cases

@pytest.mark.parametrize("arch", SMALL_ARCHS)
def test_build_case_every_method_on_meta(arch):
    """Every method and step kind builds and runs on the meta device (the
    counter raises on any tensor off it), reduced, at a small shape."""
    cfg = get_reduced(arch)
    for method in D.METHODS:
        kinds = ("train", "prefill", "decode") if method == "standard" \
            else ("train",)
        for kind in kinds:
            fn, args = D.build_case(cfg, SMALL[kind], "single", method)
            with D.count() as c:
                out = fn(*args)
            assert all(t.is_meta for t in tree_leaves(args)
                       if isinstance(t, torch.Tensor))
            assert c.argument_bytes > 0, (method, kind)
            if method != "fedavg_sync":
                assert c.flops > 0, (method, kind)
            del out


@pytest.mark.parametrize("method,variant", [
    ("standard", "chunked_ce"), ("standard", "noremat"),
    ("standard", "slotremat"), ("standard", "chunked_ce+noremat"),
    ("dml", "sparse"), ("mutual", "sparse")])
def test_variants_on_meta(method, variant):
    """The supported variants build and run on the meta device; remat
    recomputes the forward, so dropping it saves FLOPs."""
    cfg = get_reduced("qwen3-4b")
    counts = []
    for v in ("baseline", variant):
        fn, args = D.build_case(cfg, SMALL["train"], "single", method, v)
        with D.count() as c:
            fn(*args)
        counts.append(c)
    if "noremat" in variant:
        assert counts[1].flops < counts[0].flops
    if variant == "slotremat":          # one slot a period: the same work
        assert counts[1].flops == counts[0].flops


def test_collectives_from_shapes():
    cfg = get_config("qwen3-4b")
    shape = SHAPES["train_4k"]
    pub = D.public_batch(shape) * S.token_len(cfg, shape)
    dml_bytes = dml.comm_bytes(cfg, 2, pub)["dml_round"]
    assert D.collectives(cfg, shape, "single", "standard") == \
        {"client_axis": 0.0, "total": 0.0}
    assert D.collectives(cfg, shape, "single", "dml") == \
        {"client_axis": dml_bytes, "total": 0.0}
    assert D.collectives(cfg, shape, "clients", "mutual") == \
        {"client_axis": dml_bytes, "total": dml_bytes / 2}
    assert D.collectives(cfg, shape, "clients", "dml", "sparse")["total"] \
        == 2 * 2 * pub * 64 * 8 / 2
    assert D.collectives(cfg, shape, "clients", "fedavg_sync")["total"] == \
        2 * cfg.param_count() * 2


def test_refused_variants_and_meshes(capsys):
    """``flash`` stays refused; the data x model variants are axis rules
    (``mesh_rules``) that change nothing on one card; the production
    meshes are known mesh kinds."""
    cfg = get_reduced("qwen3-4b")
    for variant in ("flash", "chunked_ce+flash"):
        with pytest.raises(ValueError, match="refused"):
            D.build_case(cfg, SMALL["train"], "single", "standard", variant)
    assert D.check_variant("seqpar+no_fsdp+attn_dp") == ("seqpar", "no_fsdp",
                                                         "attn_dp")
    with pytest.raises(ValueError, match="unknown variant"):
        D.check_variant("bogus")
    with pytest.raises(ValueError, match="no clients"):
        D.build_case(cfg, SMALL["train"], "clients", "standard")
    D.check_mesh("multi", "dml")
    D.check_mesh("pod", "standard")
    with pytest.raises(ValueError, match="unknown mesh"):
        D.check_mesh("galaxy", "dml")
    rec = D.run_case("qwen3-4b", "train_4k", "single", variant="flash",
                     verbose=False)
    assert rec["status"] == "FAIL" and "xla_flash" in rec["error"]
    with pytest.raises(SystemExit):
        D.main(["--arch", "qwen3-4b", "--shape", "train_4k", "--variant",
                "flash"])
    assert "refused" in capsys.readouterr().err


def test_run_case_full_size_decode():
    rec = D.run_case("qwen3-4b", "decode_32k", "single", verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    cfg, shape = get_config("qwen3-4b"), SHAPES["decode_32k"]
    # every weight and the whole cache are read, the (B, 1) int32 ids, and
    # the position each layer makes from the host int (``torch.as_tensor``)
    assert rec["argument_bytes"] == _tree_bytes(
        S.model_state_specs(cfg), S.cache_specs(cfg, shape)) + \
        4 * shape.global_batch + 8 * cfg.n_layers
    assert rec["flops_per_device"] > rec["model_flops"] * 0.9
    t = R.roofline_terms(rec["flops_per_device"], rec["bytes_per_device"])
    assert rec["dominant"] == t["dominant"] == "t_memory"
    assert rec["t_memory"] == t["t_memory"]


def test_clients_mesh_is_a_card_share_and_cli_reads_back(tmp_path, capsys):
    out = str(tmp_path / "dry.jsonl")
    for mesh in ("single", "clients"):
        assert D.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                       "--mesh", mesh, "--method", "fedavg_sync",
                       "--out", out]) == 0
    assert D.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                   "--out", out]) == 0
    recs = [json.loads(line) for line in open(out)]
    one, two, std = recs
    assert (one["chips"], two["chips"]) == (1, 2)
    assert two["bytes_per_device"] == one["bytes_per_device"] / 2
    assert two["peak_bytes"] == one["peak_bytes"] / 2
    assert two["t_collective"] > 0 == one["t_collective"]
    assert std["status"] == "ok" and std["method"] == "standard"
    capsys.readouterr()
    assert R.main([out]) == 0
    printed = capsys.readouterr().out
    assert "| mamba2-780m | decode_32k |" in printed
    assert "| mamba2-780m | decode_32k | clients | fedavg_sync |" in printed


# ---------------------------------------------------------------------------
# the examples

def test_quickstart_cli_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu", "--rounds", "2"]) == 0
    out = capsys.readouterr().out
    assert "x 3 clients" in out and "kernels ref" in out
    assert "step   1" in out and "per-round sharing: DML=" in out


def test_serve_lm_cli_on_cpu(capsys):
    assert serve_lm.main(["--device", "cpu", "--requests", "2",
                          "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "serving mamba2-780m (reduced)" in out
    assert "wave 1: prompts(2, 24) -> generated(2, 4)" in out
