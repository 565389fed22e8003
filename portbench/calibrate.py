"""The readings the limits of ``correct`` are set from, on the chip at a
cell's own size (no measured window: training's readings need none).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out readings.jsonl]

For each of ``--seeds``: the program's checked rounds (the harness's own
set-up) against the reference: the lower readings.  For each of
``--control-seeds``: the control, the reference computed in fp8 in the
program's place, and each fault the cell can have planted in the
reference in the program's place (half of the private batch left out;
on a client mesh the exchange between cards left out), against the fp32
reference: the upper readings.  A state left unchanged reads 1 on
``update_gap`` by the measure itself and needs no run.  One JSON line a
reading.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# one intra-op thread: the process only drives the cards, and idle worker
# threads would contend for the host's few cores
os.environ.setdefault("OMP_NUM_THREADS", "1")


def faults(cell: dict) -> list:
    """The faults a cell can have that a reference run can plant."""
    return ["half_batch"] + (["no_exchange"]
                             if cell["traffic"]["cards"] > 1 else [])


@contextlib.contextmanager
def ssd_dx_half():
    """The program's SSD scan with the gradient of its input ``x`` halved
    and its sign kept: a wrong backward that AdamW's normalisation would
    hide from a check of the update alone."""
    from repro_torch.kernels import ops
    whole = ops.ssd_clients

    def wrong(x, *a, **kw):
        return whole(x.detach() + 0.5 * (x - x.detach()), *a, **kw)
    ops.ssd_clients = wrong
    try:
        yield
    finally:
        ops.ssd_clients = whole


PROGRAM_FAULTS = {"ssd_dx_half": ssd_dx_half}


def program_faults(cell: dict) -> list:
    """The faults planted in the program that a cell's kernels can have."""
    mixers = {s["mixer"] for s in cell["config"]["model"]["period"]}
    return ["ssd_dx_half"] if "mamba" in mixers else []


def program_numbers(cell: dict, seed: int, devices) -> dict:
    import torch
    from portbench import check, harness
    impl = "cuda" if devices[0].type == "cuda" else "ref"
    t0 = time.perf_counter()
    prog, readings = harness.set_up(cell, seed, devices, impl)
    t_prog = time.perf_counter() - t0
    del prog
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = check.reference_readings(cell, seed, harness.ref_devices(devices))
    return {"side": "program", "seed": seed,
            **check.numbers(readings, ref), "setup_s": t_prog,
            "reference_s": time.perf_counter() - t0}


def control_numbers(cell: dict, seed: int, devices) -> list:
    from portbench import check, harness
    devs = harness.ref_devices(devices)
    t0 = time.perf_counter()
    ref = check.reference_readings(cell, seed, devs)
    t_ref = time.perf_counter() - t0
    out = [{"side": "control_fp8", "seed": seed, **check.numbers(
        check.reference_readings(cell, seed, devs, precision="fp8"), ref),
        "reference_s": t_ref}]
    for f in faults(cell):
        out.append({"side": f"fault_{f}", "seed": seed, **check.numbers(
            check.reference_readings(cell, seed, devs, fault=f), ref)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print("calibrate: not enough CUDA devices", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    out = open(args.out, "a") if args.out else None
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    rows = [lambda s=s: [program_numbers(cell, s, devices)] for s in seeds]
    rows += [lambda s=s: control_numbers(cell, s, devices) for s in controls]
    for f in program_faults(cell):
        def planted(s, f=f):
            with PROGRAM_FAULTS[f]():
                row = program_numbers(cell, s, devices)
            return [dict(row, side=f"program_{f}")]
        rows += [lambda s=s: planted(s) for s in controls]
    for make in rows:
        for row in make():
            row["workload"] = args.workload
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        gc.collect()
        torch.cuda.empty_cache()
    print(f"calibrate: {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
