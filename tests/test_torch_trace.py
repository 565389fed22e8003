"""``repro_torch.trace``: the spans are no-ops outside a profiler and named
ranges inside one; a DML round's spans nest as its layers do; a round
counts its host syncs."""
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.api import DML, Federation, LMClients
from repro_torch.configs import get_reduced

ROUND_SPANS = {"repro.round", "repro.lm.private_batch",
               "repro.lm.public_batch", "repro.step.forward",
               "repro.step.backward", "repro.eq2", "repro.optim.adamw",
               "repro.model.embed", "repro.model.mixer", "repro.model.head",
               "repro.sync"}


def session(arch: str) -> Federation:
    pop = LMClients(get_reduced(arch), n_clients=3, rounds=4, batch=2,
                    seq=16, seed=0, device="cpu")
    return Federation(pop, DML())


def test_span_is_a_shared_noop_outside_a_profiler():
    a, b = trace.span("repro.a"), trace.span("repro.b")
    assert a is b
    with a:
        pass


def test_span_is_a_named_range_inside_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("repro.test.outer"):
            with trace.span("repro.test.inner"):
                torch.ones(4).sum()
    got = {e.name: e.time_range for e in prof.events()
           if e.name.startswith("repro.test")}
    assert set(got) == {"repro.test.outer", "repro.test.inner"}
    outer, inner = got["repro.test.outer"], got["repro.test.inner"]
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert trace.span("repro.after") is trace._OFF


def test_span_is_an_operator_range_not_a_user_annotation():
    """The profiler mirrors a user annotation onto the device timeline,
    where a reader would count it as work; an operator range it does
    not."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("repro.test.scope"):
            torch.ones(4).sum()
    (e,) = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "repro.test.scope"]
    assert not e.is_user_annotation()


def _ranges(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.name.startswith("repro.") and e.device_type == DeviceType.CPU]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_round_spans_nest_as_the_layers(arch):
    fed = session(arch)
    fed.run(until=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fed.run(until=2)
    spans = _ranges(prof)
    names = {n for n, _, _ in spans}
    assert ROUND_SPANS <= names
    assert ("repro.model.ffn" in names) == (arch == "qwen3-4b")
    by = lambda n: [s for s in spans if s[0] == n]  # noqa: E731
    (rnd,) = by("repro.round")
    assert all(_inside(s, rnd) for s in spans)
    (fwd,), (bwd,), (opt,) = (by("repro.step.forward"),
                              by("repro.step.backward"),
                              by("repro.optim.adamw"))
    assert fwd[2] <= bwd[1] and bwd[2] <= opt[1]
    for draw in by("repro.lm.private_batch") + by("repro.lm.public_batch"):
        assert draw[2] <= fwd[1]
    (eq2,) = by("repro.eq2")
    assert _inside(eq2, fwd)
    model = [s for s in spans if s[0].startswith("repro.model.")]
    assert all(_inside(s, fwd) or _inside(s, bwd) for s in model)
    # remat's recompute reopens the mixers inside the backward
    mixers = by("repro.model.mixer")
    n_fwd = sum(_inside(s, fwd) for s in mixers)
    assert n_fwd == 2 * fed.population.cfg.n_layers     # private + public
    assert sum(_inside(s, bwd) for s in mixers) == n_fwd
    # the step's read inside AdamW, the three metrics after it
    syncs = by("repro.sync")
    assert sum(_inside(s, opt) for s in syncs) == 1
    assert sum(s[1] >= opt[2] for s in syncs) == 3


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_a_round_counts_six_host_syncs(arch):
    fed = session(arch)
    fed.run(until=1)
    for r in (2, 3):
        before = dict(trace.counts)
        fed.run(until=r)
        assert trace.counts["host_sync"] - before["host_sync"] == 6
        assert trace.counts["round"] - before["round"] == 1


def test_to_host_counts_and_reads():
    before = trace.counts.get("host_sync", 0)
    assert trace.to_host(torch.tensor([1.5, 2.0])) == [1.5, 2.0]
    assert trace.to_host(torch.tensor(3, dtype=torch.int32)) == 3
    assert trace.counts["host_sync"] - before == 2
