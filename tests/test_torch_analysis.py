"""The port's roofline report (``repro_torch.analysis.roofline``) and the
card's constants (``repro_torch.launch.mesh.H100``) held against the JAX
package's ``repro.analysis.roofline`` on the same records, the JAX model
given the H100's numbers in its own ``HardwareSpec``."""
import json

import pytest
import torch

from repro.analysis import roofline as JR
from repro.launch.mesh import HardwareSpec as JaxHardwareSpec
from repro_torch.analysis import roofline as R
from repro_torch.launch import mesh as M

H100 = M.H100
JAX_H100 = JaxHardwareSpec(name=H100.name,
                           peak_flops_bf16=H100.peak_flops_bf16,
                           hbm_bandwidth=H100.hbm_bandwidth,
                           ici_bandwidth=H100.ici_bandwidth,
                           hbm_bytes=H100.hbm_bytes)


def test_h100_holds_the_published_peaks():
    assert (H100.peak_flops_bf16, H100.peak_flops_tf32,
            H100.peak_flops_fp32) == (989e12, 495e12, 67e12)
    assert (H100.hbm_bandwidth, H100.ici_bandwidth, H100.hbm_bytes) == \
        (3.35e12, 450e9, 80 * 10 ** 9)


def test_constants_single_source():
    """The report and chip_smoke.py read the card's numbers from
    ``launch.mesh.H100``; neither declares its own."""
    import chip_smoke
    assert R.H100 is H100
    assert chip_smoke.H100 is H100
    assert chip_smoke.PEAK_FLOPS == {torch.bfloat16: H100.peak_flops_bf16,
                                     torch.float32: H100.peak_flops_fp32}
    assert chip_smoke.PEAK_BYTES == H100.hbm_bandwidth


@pytest.mark.parametrize("flops,hbm,coll", [
    (989e12, 1.0, 0.0),                 # compute-bound, 1 s
    (989e12, 4 * 3.35e12, 0.0),         # memory-bound
    (0.0, 0.0, 2 * 450e9),              # collective-bound
    (0.0, 0.0, 0.0),                    # empty program
    (1.234e15, 5.6e12, 7.8e9),
])
def test_terms_match_jax(flops, hbm, coll):
    assert R.roofline_terms(flops, hbm, coll) == \
        JR.roofline_terms(flops, hbm, coll, hw=JAX_H100)


def test_terms_custom_hardware():
    hw = M.HardwareSpec(name="toy", peak_flops_bf16=100.0,
                        peak_flops_tf32=50.0, peak_flops_fp32=10.0,
                        hbm_bandwidth=10.0, ici_bandwidth=1.0, hbm_bytes=1)
    t = R.roofline_terms(200.0, 50.0, 1.0, hw=hw)
    assert (t["t_compute"], t["t_memory"], t["t_collective"]) == \
        (2.0, 5.0, 1.0)
    assert t["dominant"] == "t_memory" and t["roofline_frac"] == 0.4


def _rec(arch="qwen3-4b", shape="train_4k", mesh="single",
         method="standard", **kw):
    base = dict(arch=arch, shape=shape, mesh=mesh, method=method,
                status="ok", flops_per_device=1e15, bytes_per_device=1e12,
                collectives={"total": 1e9, "client_axis": 0},
                model_flops=6e14, useful_flop_ratio=0.6,
                peak_bytes=8 * 2**30)
    base.update(kw)
    rl = R.roofline_terms(base["flops_per_device"], base["bytes_per_device"],
                          base["collectives"]["total"])
    for k in ("t_compute", "t_memory", "t_collective", "dominant"):
        base.setdefault(k, rl[k])
    return base


def _records():
    return [_rec(),
            _rec(useful_flop_ratio=0.1),                      # a re-run
            _rec(arch="mamba2-780m", shape="decode_32k",
                 flops_per_device=1e13, bytes_per_device=5e12),
            _rec(arch="qwen3-8b", shape="prefill_32k",
                 flops_per_device=2e15, bytes_per_device=1e11,
                 useful_flop_ratio=0.3),
            _rec(arch="dbrx-132b", shape="train_4k",
                 collectives={"total": 5e12, "client_axis": 0}),
            _rec(method="dml", mesh="clients",
                 collectives={"total": 5e11, "client_axis": 1e12}),
            _rec(method="dml", mesh="single", arch="qwen3-8b",
                 collectives={"total": 0.0, "client_axis": 1e12}),
            _rec(arch="qwen1.5-110b", status="FAIL", error="OOM"),
            _rec(variant="chunked_ce", useful_flop_ratio=0.99)]


def _write(tmp_path, recs, name="dry.jsonl"):
    p = tmp_path / name
    p.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(p)


def _cells(table: str):
    """The table's rows without the advice column (the advice strings name
    the card's mechanisms, not the TPU's)."""
    return [line.rsplit("|", 2)[0] for line in table.splitlines()]


def test_load_table_and_picks_match_jax(tmp_path):
    path = _write(tmp_path, _records())
    recs, jrecs = R.load([path]), JR.load([path])
    assert recs == jrecs
    assert len(recs) == len(_records()) - 1      # the re-run replaced
    for mesh in ("single", "clients"):
        for method in ("standard", "dml"):
            ours, theirs = (R.table(recs, mesh, method),
                            JR.table(jrecs, mesh, method))
            assert _cells(ours) == _cells(theirs)
    assert R.pick_hillclimb(recs) == JR.pick_hillclimb(jrecs)
    assert set(R.pick_hillclimb(recs)) == {"worst_fraction",
                                           "most_collective",
                                           "paper_technique"}


def test_advice_names_the_card(tmp_path):
    recs = R.load([_write(tmp_path, _records())])
    advice = " ".join(R._advice(r) for r in recs)
    assert "VMEM" not in advice and "ICI" not in advice
    assert R._advice(_rec(status="FAIL")) == "fix the failure first"


def test_main_sections(tmp_path, capsys):
    path = _write(tmp_path, _records())
    assert R.main([path]) == 0
    out = capsys.readouterr().out
    assert "## Roofline -- single mesh" in out
    assert "## FL methods" in out and "| clients | dml |" in out
    assert "## Hillclimb picks" in out and "FAIL" in out


def test_main_no_records(tmp_path, capsys):
    assert R.main([str(tmp_path / "missing*.jsonl")]) == 1
