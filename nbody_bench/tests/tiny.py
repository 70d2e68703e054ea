"""A copy of the benchmark's files at a size the CPU runs in seconds: the
same cells, configurations, traffic and metrics, with fewer bodies, a
coarser mesh and shorter calls."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent

P3M = {"n_bodies": 3000, "capacity": 4096}
P3M_SIM = {"mesh_level": 10, "mesh_ny": 512, "mesh_band": 64,
           "mesh_chunk": 4096}
BH_SIM = {"max_depth": 11, "group_chunk": 16, "approx_cap": 512,
          "direct_body_cap": 1024, "frontier_cap": 512, "leaf_list_cap": 256,
          "group_cap": 0, "node_capacity": 0}
CHECK = {"random_targets": 64, "ref_level": 10}
# At this size sound runs read dv_p99 0.007-0.013 and dx_max_px 0.03 on
# seeds 1-3; the faults of faults.py read dv_p99 1.0 or dx_max_px 5-20.
LIMITS = {"dv_p99": 0.1, "dx_max_px": 1.0, "frame_px_share": 0.05}
TRAFFIC = {"batch20_seg400": {"steps_per_call": 3, "segment_steps": 9,
                              "trace_calls": 2},
           "frames2_seg400": {"segment_steps": 6, "trace_calls": 3}}


def _edit(path: Path, fn):
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


def make(tmp: Path) -> tuple[Path, dict]:
    """(the package copy's directory, the BENCHMARK.json dict)."""
    pkg = tmp / "nbody_bench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for f in (pkg / "configs").glob("*.json"):
        def small(d):
            d.update(P3M)
            d["sim_config"].update(P3M_SIM if d["solver"] == "pm"
                                   else BH_SIM)
        _edit(f, small)
    for f in (pkg / "workloads").glob("*.json"):
        def small_check(d):
            d["check"].update(CHECK)
            d["limits"].update({k: v for k, v in LIMITS.items()
                                if k in d["limits"]})
        _edit(f, small_check)
    for name, upd in TRAFFIC.items():
        _edit(pkg / "traffic" / f"{name}.json", lambda d: d.update(upd))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return pkg, bench
