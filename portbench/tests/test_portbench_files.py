"""The benchmark's files: ``BENCHMARK.json`` to its schema, and every
configuration, traffic mix, cell and per-layer metric found by its name."""
import json
import re
from pathlib import Path

import pytest

from portbench import check, harness

ROOT = Path(harness.__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"^(hidden_size|intermediate_size|.*_dim|.*_rank|"
                   r".*head.*size|.*latent.*|.*state.*|.*proj.*|expand|"
                   r".*expansion.*|num_experts_per_tok|d_model|d_ff|"
                   r"headdim)$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert list(e2e) == ["setup_s", "train_tok_s", "peak_mem_gib"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_has_its_reader(metric):
    mod = harness.metric_modules()[metric["name"]]
    assert (metric["layer"], metric["unit"], metric["moves"]) == \
        (mod.LAYER, mod.UNIT, mod.MOVES)
    assert metric["moves"] == "train_tok_s"
    assert metric["source"] in ("device_trace", "program_counter",
                                "program_span", "host_clock")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    assert UNIT.match(metric["unit"]) and "\n" not in metric["layer"]


def test_every_reader_is_listed():
    assert set(harness.metric_modules()) == \
        {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_agree_with_benchmark(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = harness.load_cell(name)
    assert cell["config"]["name"] == entry["config"]
    raw = json.loads((ROOT / "portbench" / "workloads" /
                      f"{name}.json").read_text())
    assert (raw["config"], raw["traffic"], raw["chips"], raw["why"]) == \
        (entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert len(entry["why"]) <= 200 and entry["chips"] in (1, 4)
    assert entry["chips"] == cell["traffic"]["cards"]
    assert set(cell["limits"]) <= set(check.NUMBERS) and cell["limits"]
    assert cell.get("checked_rounds", 3) in (2, 3)
    tr = cell["traffic"]
    assert tr["public_batch"] == max(1, tr["batch"] // 2)
    assert (tr["strategy"], tr["participation"], tr["loop"]) == \
        ("dml", "full", "closed")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    path = ROOT / config["file"]
    assert path.parts[len(ROOT.parts)] == "portbench"
    cfg = json.loads(path.read_text())
    assert cfg["source"].startswith("https://")
    assert config["source"] in cfg["source"]
    assert config["reduced"] == cfg["reduced"]
    assert not any(WIDTH.search(k) for k in config["reduced"])
    assert "assumed" in cfg and "deployment" in cfg
    for k in cfg["reduced"]:
        assert k in cfg["published"]
    mc = harness.model_config(cfg["model"])
    assert mc.param_dtype == "bfloat16"
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_published_widths_are_run():
    q = json.loads((ROOT / "portbench/configs/qwen3-4b.json").read_text())
    p, m = q["published"], q["model"]
    assert (m["d_model"], m["d_ff"], m["n_heads"], m["n_kv_heads"],
            m["head_dim"], m["vocab_size"]) == (
        p["hidden_size"], p["intermediate_size"], p["num_attention_heads"],
        p["num_key_value_heads"], p["head_dim"], p["vocab_size"])
    assert m["tie_embeddings"] == p["tie_word_embeddings"]
    assert m["rms_eps"] == p["rms_norm_eps"]
    mb = json.loads((ROOT / "portbench/configs/mamba2-780m.json")
                    .read_text())
    p, m = mb["published"], mb["model"]
    assert (m["d_model"], m["n_layers"]) == (p["d_model"], p["n_layer"])
    pad = p["pad_vocab_size_multiple"]
    assert m["vocab_size"] == -(-p["vocab_size"] // pad) * pad


def test_four_chip_cells_are_few():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)


def test_check_fits_the_time():
    n = len(CELLS)
    total = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
    assert n <= 24 and total <= 43200
