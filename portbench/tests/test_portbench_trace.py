"""The reduction of a trace to the per-layer metrics, on a made-up trace."""
import pytest

from portbench import harness
from portbench.yard import trace as T

from portbench_tiny import cell


def fake_trace():
    """Two rounds of 1,000 us on two cards; card 0 busy 100..400 and
    300..500 (overlapping) in round 1 and 1,200..1,700 in round 2, card 1
    one Eq.-2 kernel of 100 us in each round and a peer copy."""
    acts = [T.Activity("void at::native::add_kernel<float>(X)", 0, 100, 400),
            T.Activity("void at::native::add_kernel<float>(X)", 0, 300, 500),
            T.Activity("void (anonymous namespace)::kl_square_fwd<float, 3>"
                       "(Params)", 1, 600, 700),
            T.Activity("Memcpy PtoP (Device -> Device)", 1, 700, 800),
            T.Activity("gemm", 0, 1200, 1700),
            T.Activity("void (anonymous namespace)::kl_square_bwd<float, 3>"
                       "(Params)", 1, 1300, 1400)]
    spans = [("bench.round", 0, 1000), ("bench.round", 1000, 2000),
             ("bench.private_batch", 1000, 1150),
             ("bench.public_batch", 1750, 1800)]
    return T.Trace(acts, spans, [(0, 1000), (1000, 2000)], [0, 1])


def ctx(cards=1):
    return harness.Context(cell("attn", clients=4, cards=cards),
                           fake_trace(), 10, 5.0)


def test_base_names():
    assert T.base_name("void (anonymous namespace)::tc::attn_fwd_tc<128>"
                       "(Args)") == "attn_fwd_tc"
    assert T.base_name("ssd_tc::chunk_out(ssd_tc::Params)") == "chunk_out"
    assert T.base_name("nvjet_tst_320x128") == "nvjet_tst_320x128"


def test_union_counts_overlap_once():
    assert T.device_union([(0, 10), (5, 15), (20, 30)]) == 25
    assert T.overlap_us([(0, 10), (20, 30)], [(5, 25), (8, 12)]) == 10


def test_busy_and_gaps():
    tr = fake_trace()
    assert T.busy_us(tr, 0) == 400 + 500
    assert T.idle_gaps(tr, 0) == [(0, 100), (500, 1200), (1700, 2000)]
    assert T.span_at(tr, 1100) == "bench.private_batch"


def test_readers():
    mods = harness.metric_modules()
    c = ctx()
    # round 1 ends at 800 on any card, round 2 starts at 1,200 (the
    # private draw inside that gap counts once); each card idles through
    # the public draw at 1,750..1,800: (400 + 50) us a card, over 2 rounds
    assert mods["host_gap_ms_per_round"].read(c) == pytest.approx(0.225)
    assert mods["kernels_per_round"].read(c) == 2.5
    idle = (1 - 900 / 2000 + 1 - 300 / 2000) / 2
    assert mods["device_idle_pct"].read(c) == pytest.approx(100 * idle)
    assert mods["eq2_roofline_pct"].read(c) > 0
    assert mods["flash_roofline_pct"].read(c) is None     # no flash kernel
    assert mods["ssd_roofline_pct"].read(c) is None
    assert mods["mfu_pct"].read(c) > 0


def test_breakdown():
    b = harness.breakdown(ctx())
    assert set(b) == {"device_ops", "idle_gaps"}
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0][0] == "void at::native::add_kernel<float>(X)"
    labels = dict(b["idle_gaps"])
    assert "private_batch" in labels and "round" in labels
