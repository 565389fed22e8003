"""Roofline report from the port's dry-run JSONL records (the port of
``repro/analysis/roofline.py``).

Per (arch x shape x mesh x method): the three terms
    t_compute    = FLOPs_per_device / peak_FLOP/s
    t_memory     = bytes_per_device / HBM_bw
    t_collective = collective_bytes_per_device / link_bw
plus the dominant term, MODEL_FLOPS = 6*N_active*D, the useful-FLOP ratio,
and a rule-based one-liner on what would move the dominant term.

The card's constants live in ONE place, ``launch.mesh.H100`` (NVIDIA's
published dense peaks of an H100 SXM at 700 W: 989 TFLOP/s bf16, 3.35 TB/s
HBM3, 450 GB/s one way over NVLink 4); ``roofline_terms`` below is the one
implementation of the three-term model.  The arithmetic, the dedup key
and the picks are the JAX module's.  The counts come from
``launch.dryrun`` on the meta device: matmul-class FLOPs and unfused op
bytes, so the terms are bounds at the published peaks, not measurements.

  PYTHONPATH=src python -m repro_torch.analysis.roofline build/dryrun/*.jsonl
"""
from __future__ import annotations

import glob
import json
import sys
from typing import Dict, List, Optional

from repro_torch.launch.mesh import H100, HardwareSpec

# the dry-run's mesh kinds: one card, one client a card over the client
# mesh, and the data x model production meshes (data 16 x model 16, and
# pod 2 x 16 x 16)
MESH_KINDS = ("single", "clients", "pod", "multi")


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float = 0.0,
                   hw: Optional[HardwareSpec] = None) -> Dict[str, object]:
    """The three-term roofline model for one program / one device.

    Returns ``t_compute`` / ``t_memory`` / ``t_collective`` (seconds at the
    hardware's peaks), ``t_bound`` (their max -- the model's minimum
    wall-clock), ``dominant`` (bottleneck attribution: which term binds)
    and ``roofline_frac`` (t_compute / t_bound -- 1.0 means the program sits
    on the compute roofline; below 1.0, the gap is memory/collective time).
    ``flops`` count at the bf16 tensor-core peak.
    """
    hw = hw or H100
    t = {"t_compute": flops / hw.peak_flops_bf16,
         "t_memory": hbm_bytes / hw.hbm_bandwidth,
         "t_collective": coll_bytes / hw.ici_bandwidth}
    bound = max(t.values())
    t["t_bound"] = bound
    t["dominant"] = max(("t_compute", "t_memory", "t_collective"),
                        key=lambda k: t[k])
    t["roofline_frac"] = t["t_compute"] / bound if bound > 0 else 1.0
    return t


def load(paths: List[str]) -> List[Dict]:
    recs = []
    for pattern in paths:
        for path in sorted(glob.glob(pattern)):
            with open(path) as f:
                for line in f:
                    if line.strip():
                        recs.append(json.loads(line))
    # last record wins per key (re-runs overwrite)
    dedup = {}
    for r in recs:
        dedup[(r["arch"], r["shape"], r["mesh"], r["method"],
               r.get("variant", "baseline"))] = r
    return list(dedup.values())


def _advice(r: Dict) -> str:
    dom = r.get("dominant", "-")
    shape = r["shape"]
    if r["status"] != "ok":
        return "fix the failure first"
    if dom == "t_compute":
        if r.get("useful_flop_ratio", 0) < 0.5:
            return ("compute-bound but <50% useful FLOPs: reduce remat "
                    "recompute / MoE capacity padding")
        return "near compute roofline: only larger batch or fewer FLOPs help"
    if dom == "t_memory":
        if shape in ("decode_32k", "long_500k"):
            return ("decode is cache-bandwidth-bound: shrink KV (window/"
                    "quantize) or raise batch to amortise weight reads")
        if shape == "prefill_32k":
            return ("O(S^2) attention buffers dominate: use the flash "
                    "kernel (impl cuda) instead of the plain attention")
        return ("activation traffic dominates: fuse (flash attention, "
                "chunked CE, a fused AdamW) so HBM sees each tensor once")
    if dom == "t_collective":
        return ("NVLink-bound: gather fewer logits (top-k prediction "
                "sharing in DML mode) or overlap the gather with compute")
    return "-"


def table(recs: List[Dict], mesh: str = "single",
          method: str = "standard") -> str:
    rows = [r for r in recs if r["mesh"] == mesh and r["method"] == method
            and r.get("variant", "baseline") == "baseline"]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = ["| arch | shape | t_comp(s) | t_mem(s) | t_coll(s) | dominant | "
           "model TFLOPs | useful | peak GB/dev | advice |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | FAIL | | | | | | | "
                       f"{r.get('error', '')[:60]} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute']:.4f} | "
            f"{r['t_memory']:.4f} | {r['t_collective']:.4f} | "
            f"{r['dominant'].replace('t_', '')} | "
            f"{r['model_flops'] / 1e12:.1f} | "
            f"{r['useful_flop_ratio']:.2f} | "
            f"{r['peak_bytes'] / 2**30:.1f} | {_advice(r)} |")
    return "\n".join(out)


def pick_hillclimb(recs: List[Dict]) -> Dict[str, Dict]:
    """The three §Perf pairs: worst roofline fraction, most collective-bound,
    most representative of the paper's technique (the DML case)."""
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"] == "single"
          and r["method"] == "standard"]
    out = {}
    if ok:
        # worst fraction: dominant term vs the best achievable (compute term)
        def waste(r):
            t = max(r["t_compute"], r["t_memory"], r["t_collective"])
            return t / max(r["t_compute"], 1e-12)
        out["worst_fraction"] = max(ok, key=waste)
        out["most_collective"] = max(ok, key=lambda r: r["t_collective"] /
                                     max(r["t_compute"], 1e-12))
    dml = [r for r in recs if r["status"] == "ok" and r["method"] == "dml"]
    if dml:
        out["paper_technique"] = max(dml, key=lambda r: r["t_collective"])
    return out


def main(argv=None) -> int:
    paths = (argv or sys.argv[1:]) or ["build/dryrun/*.jsonl"]
    recs = load(paths)
    if not recs:
        print("no records found", file=sys.stderr)
        return 1
    for mesh in MESH_KINDS:
        subset = [r for r in recs if r["mesh"] == mesh
                  and r["method"] == "standard"]
        if subset:
            print(f"\n## Roofline -- {mesh} mesh, standard steps "
                  f"({len(subset)} cases; bounds at {H100.name}'s published "
                  "peaks, counted on the meta device)\n")
            print(table(recs, mesh=mesh))
    fl = [r for r in recs if r["method"] in ("dml", "mutual", "fedavg_sync")]
    if fl:
        print("\n## FL methods (clients = cards on the clients mesh)\n")
        print("| arch | shape | mesh | method | t_coll(s) | client-axis "
              "bytes | coll bytes/dev |")
        print("|---|---|---|---|---|---|---|")
        for r in sorted(fl, key=lambda r: (r["arch"], r["mesh"],
                                           r["method"])):
            if r["status"] != "ok":
                print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                      f"{r['method']} | FAIL | | "
                      f"{r.get('error', '')[:60]} |")
                continue
            c = r["collectives"]
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                  f"{r['method']} | {r['t_collective']:.4f} | "
                  f"{c.get('client_axis', 0) / 2**20:.1f} MiB | "
                  f"{c['total'] / 2**30:.2f} GiB |")
    picks = pick_hillclimb(recs)
    if picks:
        print("\n## Hillclimb picks\n")
        for why, r in picks.items():
            print(f"- {why}: {r['arch']} x {r['shape']} x {r['method']} "
                  f"(dominant {r.get('dominant', '-')})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
