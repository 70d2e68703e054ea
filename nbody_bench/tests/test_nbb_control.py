"""The control — the plain reference in bfloat16 in the program's place
— comes out not correct, at a size the CPU holds (on the card, at the
cells' own size: ``python3 -m nbody_bench.control``)."""

import pytest

from nbody_bench import control, run
from nbody_bench.tests import tiny


@pytest.mark.parametrize("cell", ["p3m_collide1m_batch",
                                  "p3m_collide1m_frames"])
def test_control_is_not_correct(tmp_path, cell):
    pkg, bench = tiny.make(tmp_path)
    res = run.run(cell, 11, 0.5, False, device="cpu", bench=bench, pkg=pkg,
                  make_system=control.Control)
    assert not res["correct"]
    assert res["checks"]["dv_p99"]["value"] > \
        res["checks"]["dv_p99"]["limit"]
