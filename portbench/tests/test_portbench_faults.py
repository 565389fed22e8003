"""A whole run on the CPU (the harness's look for a card skipped) with the
timed path broken underneath: ``correct`` comes out false for each fault
a training cell can have."""
import time

import pytest
import torch

from portbench import harness

from portbench_tiny import cell

CPU = [torch.device("cpu")]
SEED = 2 ** 31 + 23


def run(c):
    return harness.run_cell(c, SEED, 1.5, False, CPU, time.perf_counter())


def test_sound_run_is_correct():
    out = run(cell("attn"))
    assert out["correct"] is True
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"setup_s", "train_tok_s",
                                   "peak_mem_gib"}


def test_state_left_unchanged(monkeypatch):
    from repro_torch.core import distributed

    def frozen(params, grads, state, cfg, client_scale=None):
        state["step"] += 1
        return params, state, {"grad_norm": None, "lr": torch.tensor(0.0)}
    monkeypatch.setattr(distributed, "adamw_update", frozen)
    out = run(cell("attn"))
    assert out["correct"] is False
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(monkeypatch):
    from repro_torch.models import transformer
    whole = transformer.loss_fn_clients

    def half(sparams, cfg, tokens, *a, **kw):
        if tokens.dim() == 3:              # the private batch (K, B, S)
            tokens = tokens[:, :tokens.shape[1] // 2]
        return whole(sparams, cfg, tokens, *a, **kw)
    monkeypatch.setattr(transformer, "loss_fn_clients", half)
    assert run(cell("mamba"))["correct"] is False


def test_ssd_backward_wrong_keeping_its_sign():
    from portbench import calibrate
    with calibrate.ssd_dx_half():
        out = run(cell("mamba"))
    assert out["correct"] is False
    med = out["checks"]["grad_gap_median"]
    assert med["value"] > med["limit"]


def test_exchange_between_cards_left_out(monkeypatch):
    from repro_torch.core import distributed
    c = cell("attn", clients=4, cards=2)
    assert run(c)["correct"] is True
    whole = distributed._pair_mask

    def local(K, part_mask, device=None):
        w = whole(K, part_mask, device)
        n = c["traffic"]["cards"]
        same = torch.tensor([[float(i % n == j % n) for j in range(K)]
                             for i in range(K)], device=w.device)
        w = w * same
        return w / w.sum(dim=1, keepdim=True).clamp(min=1e-30)
    monkeypatch.setattr(distributed, "_pair_mask", local)
    assert run(c)["correct"] is False
