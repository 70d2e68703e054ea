"""A copy of the benchmark's files at a size the CPU runs in seconds: the
same cells, configurations, traffic and metrics, with fewer bodies, a
coarser mesh and shorter calls; and a 3D cell that no ``BENCHMARK.json``
names yet, the GPU demo's sphere (:func:`add_sphere3d`)."""

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


SPHERE3D = "sphere3d_tiny_frames"
# The GPU demo's ball (gpu/GPU.kt:657-735): exact 3D all-pairs forces,
# semi-implicit Euler, no merging, a 430 x 180 frame a step under the
# orbiting camera; 2,000 satellites and the central body.
SPHERE3D_CONFIG = {
    "name": "sphere3d_tiny", "scene": "sphere3d", "source": "test",
    "reduced": ["n_bodies"], "n_bodies": 2001, "capacity": 2048,
    "world_w": 3440.0, "world_h": 1440.0, "solver": "allpairs",
    "integrator": "euler", "merge_heavy_cap": 64,
    "params": {"G": 80.0, "dt": 0.005, "softening": 1.0, "theta": 0.3,
               "merge_max_mass": 4000.0, "merge_min_dist": 0.0},
    "sim_config": {"dim": 3}}
SPHERE3D_TRAFFIC = {
    "loop": "frames3d", "steps_per_frame": 1, "segment_steps": 6,
    "warm_calls": 2, "trace_calls": 3, "width": 430, "height": 180,
    "speed_scale": 0.0001, "gain": 0.6, "cam_pitch": 0.2617994,
    "yaw_per_frame": 0.004, "world_scale": 0.125}
# At this size sound runs read dv_p99 ~1e-6, dx_max_px ~1e-4 and
# frame_px_share under 1e-3 on seeds 1-3; each fault of faults.py reads
# dv_p99 0.5 or more, dx_max_px 20, or frame_px_share 0.5 or more.
SPHERE3D_WORKLOAD = {
    "check": {"calls": 2, "start_steps": 2, "random_targets": 64,
              "calm_px": 30.0, "merge_slack_px": 0.001,
              "kill_slack_px": 1.0},
    "limits": {"dv_p99": 0.01, "dx_max_px": 0.1, "merge_left": 0,
               "killed_far": 0, "mass_gap": 1e-05, "frame_px_share": 0.05}}


def add_sphere3d(pkg: Path, bench: dict) -> str:
    """Write the 3D cell's configuration, traffic and workload files into
    the copy at ``pkg`` and its entries into ``bench``; returns its name."""
    for kind, name, data in (
            ("configs", SPHERE3D_CONFIG["name"], SPHERE3D_CONFIG),
            ("traffic", "frames3d_tiny", SPHERE3D_TRAFFIC),
            ("workloads", SPHERE3D, SPHERE3D_WORKLOAD)):
        (pkg / kind / f"{name}.json").write_text(json.dumps(data, indent=1))
    bench["configs"].append({"name": SPHERE3D_CONFIG["name"],
                             "source": "test",
                             "file": "nbody_bench/configs/sphere3d_tiny.json",
                             "reduced": ["n_bodies"], "why": "test"})
    bench["workloads"].append({"name": SPHERE3D, "config": "sphere3d_tiny",
                               "traffic": "frames3d_tiny", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("frames_per_s", "frame_ms_p95"):
            m["workloads"] = m["workloads"] + [SPHERE3D]
    return SPHERE3D
