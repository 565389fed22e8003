"""The program's own spans and counters as the benchmark sees them: the
host-sync reader, the accepted readers unchanged by the program's ranges,
and ``spans.py``'s table on a made-up profile and on a tiny CPU round."""
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness
from portbench import spans as S
from portbench.metrics import host_syncs_per_round as H
from portbench.yard import trace as T

from portbench_tiny import cell

ACCEPTED = ("host_gap_ms_per_round", "kernels_per_round", "eq2_roofline_pct",
            "flash_roofline_pct", "ssd_roofline_pct", "device_idle_pct",
            "mfu_pct")
# two rounds of 1,000 us on two cards (as test_portbench_trace.py's
# fake_trace): (name, card, start, end, host time of its launch call)
DEVICE = [("void at::native::add_kernel<float>(X)", 0, 100, 400, 60),
          ("void at::native::add_kernel<float>(X)", 0, 300, 500, 360),
          ("void (anonymous namespace)::kl_square_fwd<float, 3>(Params)", 1,
           600, 700, 600),
          ("Memcpy PtoP (Device -> Device)", 1, 700, 800, 650),
          ("gemm", 0, 1200, 1700, 1510),
          ("void (anonymous namespace)::kl_square_bwd<float, 3>(Params)", 1,
           1300, 1400, None)]
BENCH = [("bench.round", 0, 1000), ("bench.round", 1000, 2000),
         ("bench.private_batch", 1000, 1150),
         ("bench.public_batch", 1750, 1800)]
PROGRAM = [("repro.round", 0, 1000), ("repro.round", 1000, 2000),
           ("repro.step.forward", 50, 350), ("repro.step.backward", 350, 550),
           ("repro.optim.adamw", 550, 900),
           ("repro.step.forward", 1100, 1300),
           ("repro.step.backward", 1300, 1500),
           ("repro.optim.adamw", 1500, 1900)]


def event(name, kind, start, end, card=0, id=0):
    return SimpleNamespace(name=name, device_type=kind, device_index=card,
                           id=id, time_range=SimpleNamespace(start=start,
                                                             end=end))


def fake_profile(program=True, mirrors=False):
    """The profiler's events of the two rounds: the benchmark's host
    ranges with their device mirrors, the device activities and, with
    ``program``, the program's host ranges and the runtime calls that
    launched each activity (correlation ids 1..)."""
    ev = [event(n, DeviceType.CPU, s, e) for n, s, e in BENCH]
    ev += [event(n, DeviceType.CUDA, s, e) for n, s, e in BENCH]
    for i, (n, card, s, e, t) in enumerate(DEVICE, start=1):
        ev.append(event(n, DeviceType.CUDA, s, e, card, i))
        if program and t is not None:
            ev.append(event("cudaLaunchKernel", DeviceType.CPU, t, t + 5,
                            id=i))
    if program:
        ev += [event(n, DeviceType.CPU, s, e) for n, s, e in PROGRAM]
    if mirrors:
        ev += [event(n, DeviceType.CUDA, s, e) for n, s, e in PROGRAM]
    return SimpleNamespace(events=lambda: ev)


def context(prof):
    return harness.Context(cell("attn", clients=4),
                           T.from_profiler(prof, [0, 1], harness.ROUND_SPAN),
                           10, 5.0)


def readings(prof):
    mods = harness.metric_modules()
    c = context(prof)
    return ({n: mods[n].read(c) for n in ACCEPTED}, harness.breakdown(c))


def test_accepted_readers_unchanged_by_the_programs_ranges():
    plain = readings(fake_profile(program=False))
    assert plain[0]["kernels_per_round"] == 2.5
    assert readings(fake_profile()) == plain
    # a range the profiler mirrored onto the device would read as work
    mirrored = readings(fake_profile(mirrors=True))
    assert mirrored[0]["kernels_per_round"] == 6.5


def test_parse():
    p = S.parse(fake_profile(), [0, 1])
    assert p.trace.activities == context(fake_profile()).trace.activities
    assert p.launches == [t for *_, t in DEVICE]
    assert sorted(p.program) == sorted(PROGRAM)
    assert p.mirrors == 0
    assert S.parse(fake_profile(mirrors=True), [0, 1]).mirrors == len(PROGRAM)


def test_span_paths_and_launched_in():
    p = S.parse(fake_profile(), [0, 1])
    at = S.span_paths(p.program)
    assert at(-1) == ()
    assert at(60) == ("repro.round", "repro.step.forward")
    assert at(1000) == ("repro.round",)
    assert at(1510) == ("repro.round", "repro.optim.adamw")
    assert at(2500) == ()
    assert [a.start for a in S.launched_in(p, S.ADAMW)] == [600, 700, 1200]


def test_span_numbers():
    p = S.parse(fake_profile(), [0, 1])
    # launched inside AdamW: kl_square_fwd 100 us, the copy 100, the gemm
    # 500; over 2 cards and 2 rounds
    assert S.adamw_ms(p) == pytest.approx(0.175)
    # idle inside forward / backward (50..550, 1,100..1,500): card 0
    # 50 + 50 + 100 us, card 1 500 + 200 + 100 us; mean over cards, a round
    assert S.launch_idle_ms(p) == pytest.approx(0.25)
    bare = S.parse(fake_profile(program=False), [0, 1])
    assert S.adamw_ms(bare) is None and S.launch_idle_ms(bare) is None


def test_table():
    t = S.table(S.parse(fake_profile(), [0, 1]))
    rows = {r[0]: r[1:] for r in t["rows"]}
    # per round and card: the forward's add kernel (300 us), the
    # backward's (200 us), AdamW's two kernels and a copy (700 us), the
    # Eq.-2 backward whose launch the profile does not link (100 us)
    assert rows["round > step.forward"][:2] == pytest.approx([0.25, 0.075])
    assert rows["round > step.backward"][:2] == pytest.approx([0.25, 0.05])
    assert rows["round > optim.adamw"][:2] == pytest.approx([0.5, 0.175])
    assert rows["launch not linked"][:2] == pytest.approx([0.25, 0.025])
    assert t["covered"] == pytest.approx(1100 / 1200)
    assert t["linked"] == pytest.approx(5 / 6)


def test_host_syncs_reader(monkeypatch):
    c = context(fake_profile())
    monkeypatch.setattr(H, "program_counts",
                        lambda: {"host_sync": 24, "round": 4})
    assert H.read(c) == 6 and isinstance(H.read(c), int)
    monkeypatch.setattr(H, "program_counts",
                        lambda: {"host_sync": 13, "round": 2})
    assert H.read(c) == 6.5
    for counts in ({}, {"host_sync": 3}, {"host_sync": 3, "round": 0}):
        monkeypatch.setattr(H, "program_counts", lambda: counts)
        assert H.read(c) is None


def test_host_syncs_reader_reads_the_program():
    from repro_torch import trace
    assert H.program_counts() == trace.counts


@pytest.mark.parametrize("mixer", ["attn", "mamba"])
def test_tiny_rounds_by_span(mixer, monkeypatch):
    from repro_torch import trace
    monkeypatch.setattr(trace, "counts", {})
    prog, _ = harness.set_up(cell(mixer), 7, [torch.device("cpu")], "ref")
    assert trace.counts["host_sync"] == 6 * trace.counts["round"]
    assert harness.metric_modules()["host_syncs_per_round"].read(None) == 6
    p, syncs = S.profile_rounds(prog, 2, [0])
    assert syncs == 6
    assert [n for n, _, _ in p.program].count("repro.round") == 2
    assert len(p.trace.rounds) == 2 and p.mirrors == 0
    names = {n for n, _, _ in p.program}
    assert {"repro.optim.adamw", "repro.step.forward", "repro.step.backward",
            "repro.eq2", "repro.sync"} <= names
    assert S.table(p)["rows"]          # the idle of the CPU's empty card
