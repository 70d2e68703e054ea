"""The command's refusals, and a whole run at a size the CPU holds."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from nbody_bench import run
from nbody_bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


def test_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "nbody_bench.run", "--workload",
         "p3m_collide1m_batch", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("cell,traced", [("p3m_collide1m_batch", False),
                                         ("p3m_collide1m_batch", True),
                                         ("bh_collide1m_batch", False),
                                         ("p3m_collide1m_frames", True)])
def test_tiny_run(tmp_path, cell, traced):
    pkg, bench = tiny.make(tmp_path)
    res = run.run(cell, 2 ** 31 + 77, 1.0, traced, device="cpu",
                  bench=bench, pkg=pkg)
    json.dumps(res)
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = {m["name"] for m in (run.manifest.Cell(cell, bench, pkg)
                                 .per_layer if traced else
                                 run.manifest.Cell(cell, bench, pkg)
                                 .end_to_end)}
    if not traced:
        assert set(res["metrics"]) == names
        assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) >= {"dv_p99", "dx_max_px", "merge_left"}
    assert ("frame_px_share" in res["checks"]) == ("frames" in cell)
