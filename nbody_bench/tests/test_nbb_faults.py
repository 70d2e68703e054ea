"""A whole run with the timed path broken underneath, past the look for a
card: ``correct`` has to come out false for each fault a cell can have,
and true for the sound program. (One card: no exchange between chips to
leave out.)"""

import pytest

from nbody_bench import run
from nbody_bench.tests import faults, tiny

CELLS = ["p3m_collide1m_batch", "bh_collide1m_batch", "p3m_collide1m_frames"]


def _run(tmp_path, cell, make_system, seed=3):
    pkg, bench = tiny.make(tmp_path)
    return run.run(cell, seed, 0.5, False, device="cpu", bench=bench,
                   pkg=pkg, make_system=make_system)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(tmp_path, cell):
    res = _run(tmp_path, cell, None)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(tmp_path, cell, fault):
    res = _run(tmp_path, cell, faults.program_with(faults.FAULTS[fault]))
    assert not res["correct"], res["checks"]


def test_altered_frame_is_caught(tmp_path, monkeypatch):
    from tpu_nbody_torch.ops import render

    real = render.to_uint8
    monkeypatch.setattr(render, "to_uint8", lambda fb: real(fb * 0.5))
    res = _run(tmp_path, "p3m_collide1m_frames", None)
    assert not res["correct"]
    assert res["checks"]["frame_px_share"]["value"] > \
        res["checks"]["frame_px_share"]["limit"]
