"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` (with
``build_s``, the seconds the kernels' build or load took in set-up), with
``--trace 1`` the ``breakdown``, and last the ``checks``: each number
compared beside its limit, which also end standard error.  Exits 2 without
a result where the cards the cell asks for are not there, and 3 where JAX
or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# one intra-op thread: the process only drives the cards, and idle worker
# threads would contend for the host's few cores
os.environ.setdefault("OMP_NUM_THREADS", "1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness

    cell = harness.load_cell(args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible: nothing was run", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    result = harness.run_cell(cell, args.seed % 2 ** 63, args.seconds,
                              bool(args.trace), devices, T_START)
    bad = harness.banned_modules()
    if bad:
        print(f"portbench: loaded {bad} in the measuring process; no "
              "result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
