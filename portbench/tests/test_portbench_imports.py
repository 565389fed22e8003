"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole), and no result without the port or a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.__file__).resolve().parent.parent
PROBE = """
import sys, time, json
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import torch
from portbench import harness, calibrate
from portbench_tiny import cell
harness.run_cell(cell("attn"), 5, 3.0, True, [torch.device("cpu")],
                 time.perf_counter(), log=open("/dev/null", "w"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_a_run_loads_no_jax():
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                        tests=str(Path(__file__).parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro" not in harness.banned_modules() or "repro" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro" in harness.banned_modules()


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                          "--workload", "qwen3-4b.dml-k3", "--seed",
                          "2147483649", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=_env(),
                         timeout=120, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_bare_checkout_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "qwen3-4b.dml-k3", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, env=_env(), timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.portbench_chip
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "qwen3-4b.dml-k3", "--seed", "2147483650",
                          "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
