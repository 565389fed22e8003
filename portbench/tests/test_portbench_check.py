"""The comparison that decides ``correct``, on the CPU at a reduced size:
the port at impl "ref" against the plain reference over the checked
rounds, and the control (the reference in fp8 in the program's place),
which has to fail it."""
import pytest
import torch

from portbench import calibrate, check, harness

from portbench_tiny import LIMITS, cell

CPU = [torch.device("cpu")]
SEED = 2 ** 31 + 11


@pytest.mark.parametrize("mixer", ["attn", "mamba"])
def test_port_agrees_with_the_reference(mixer):
    row = calibrate.program_numbers(cell(mixer), SEED, CPU)
    nums = {k: row[k] for k in check.NUMBERS}
    assert check.judge(nums, LIMITS), nums
    assert all(v > 0 for v in nums.values())     # bf16 against fp32


@pytest.mark.parametrize("mixer", ["attn", "mamba"])
def test_the_fp8_control_fails(mixer):
    rows = calibrate.control_numbers(cell(mixer), SEED + 1, CPU)
    control = next(r for r in rows if r["side"] == "control_fp8")
    assert not check.judge({k: control[k] for k in check.NUMBERS}, LIMITS)
    half = next(r for r in rows if r["side"] == "fault_half_batch")
    assert half["grad_gap"] > LIMITS["grad_gap"]


def test_the_reference_is_deterministic():
    c = cell("attn")
    a = check.reference_readings(c, SEED, CPU)
    b = check.reference_readings(c, SEED, CPU)
    assert check.numbers(a, b) == {k: 0.0 for k in check.NUMBERS}


def test_a_state_left_unchanged_reads_one():
    c = cell("attn")
    ref = check.reference_readings(c, SEED, CPU)
    frozen = check.Readings(ref.losses, ref.grad_norms,
                            [{p: 0.0 for p in d} for d in ref.change_norms])
    assert check.numbers(frozen, ref)["update_gap"] == pytest.approx(1.0)


def test_the_program_departing_from_the_stated_optimizer_is_refused():
    c = cell("attn")
    c["traffic"]["clip_norm"] = 0.5
    with pytest.raises(ValueError, match="optimizer"):
        harness.Program(c, SEED, CPU, "ref")


@pytest.mark.parametrize("key,value", [("temperature", 2.0),
                                       ("strategy", "fedavg")])
def test_traffic_the_program_cannot_drive_is_refused(key, value):
    c = cell("attn")
    c["traffic"][key] = value
    with pytest.raises(ValueError, match="cannot drive"):
        harness.Program(c, SEED, CPU, "ref")
