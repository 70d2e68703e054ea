"""The port's example programs (``python -m tpu_nbody_torch.examples.*``)
at a tiny size on the CPU: each ``main`` runs to its end with
``--device cpu`` and writes or prints what it should."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_nbody_torch import checkpoint as tcheckpoint
from tpu_nbody_torch import profiling
from tpu_nbody_torch.examples import (collide_demo, drift_benchmark,
                                      interactive, sphere3d_demo)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _gif_frames(path):
    """The image count of a GIF89a file with a 256-entry global color
    table, walking its blocks to the trailer, and its bytes."""
    raw = path.read_bytes()
    assert raw[:6] == b"GIF89a" and raw[10] == 0xF7

    def skip_sub_blocks(i):
        while raw[i]:
            i += 1 + raw[i]
        return i + 1

    i, frames = 13 + 768, 0
    while raw[i] != 0x3B:
        assert raw[i] in (0x21, 0x2C), f"unknown block {raw[i]:#x} at {i}"
        if raw[i] == 0x21:          # extension: label, then sub-blocks
            i = skip_sub_blocks(i + 2)
        else:                       # image: descriptor, code size, data
            frames += 1
            i = skip_sub_blocks(i + 11)
    assert i == len(raw) - 1
    return frames, raw


def test_sphere3d_demo_writes_the_gif(tmp_path, capsys):
    out = tmp_path / "sphere.gif"
    assert sphere3d_demo.main(
        ["--out", str(out), "--n", "300", "--frames", "15",
         "--steps-per-frame", "2", "--width", "86", "--height", "36",
         "--device", "cpu"]) == str(out)
    n, raw = _gif_frames(out)
    assert n == 15 and raw[6:10] == (86).to_bytes(2, "little") + (
        36).to_bytes(2, "little")
    text = capsys.readouterr().out
    assert "frame 15/15" in text and f"wrote {out}" in text


def test_sphere3d_demo_matches_the_jax_script(tmp_path, monkeypatch):
    """``examples/sphere3d_demo.py`` run as a script, its frames caught at
    ``write_gif``, against the port's loop on the script's own bodies: the
    scaling of the world, the camera's advance, the Euler step and the
    render parameters. uint8 frames within 1 level, on at most 5 pixels a
    frame (float32 sums taken in another order on both sides). The frame's
    sides are odd, so that the central body, which stays at the middle of
    the screen, lies in the middle of a pixel and not on an edge, where the
    last bit decides which pixel it lights."""
    import runpy

    import jax
    from tpu_nbody import viewer as jviewer
    from tpu_nbody.models import scenes3d as jscenes3d

    caught = {}
    monkeypatch.setattr(jviewer, "write_gif",
                        lambda path, frames, fps: caught.update(
                            path=path, frames=np.stack(frames), fps=fps))
    monkeypatch.setattr(sys, "argv", [
        "sphere3d_demo.py", "--out", str(tmp_path / "j.gif"), "--n", "300",
        "--frames", "6", "--steps-per-frame", "2", "--width", "87",
        "--height", "37"])
    runpy.run_path(str(REPO / "examples" / "sphere3d_demo.py"),
                   run_name="__main__")
    want = caught["frames"]
    assert want.shape == (6, 37, 87, 3) and caught["fps"] == 25

    bodies = [np.array(x) for x in
              jscenes3d.generate_sphere(jax.random.PRNGKey(1), 300)]
    eng, frames = sphere3d_demo.simulate(300, 6, 2, 87, 37, device="cpu",
                                         bodies=bodies)
    assert int(eng.state.step) == 12
    diff = np.abs(frames.numpy().astype(int) - want.astype(int))
    assert want.sum() > 0 and diff.max() <= 1
    assert (diff.max(axis=-1) > 0).sum(axis=(1, 2)).max() <= 5


def test_sphere3d_simulate_times_its_phases():
    pt = profiling.PhaseTimer()
    eng, frames = sphere3d_demo.simulate(200, 3, 2, 64, 32, device="cpu",
                                         timer=pt)
    assert frames.shape == (3, 32, 64, 3) and frames.dtype == torch.uint8
    assert int(frames.sum()) > 0 and not torch.equal(frames[0], frames[2])
    assert eng.state.dim == 3 and int(eng.state.step) == 6
    assert int(eng.state.n_alive()) == 201
    assert pt.counts == {"scene": 1, "step": 3, "render": 3}
    # the same seed gives the same movie
    again = sphere3d_demo.simulate(200, 3, 2, 64, 32, device="cpu")[1]
    assert torch.equal(again, frames)


@pytest.mark.parametrize("extra", [[], ["--fused"],
                                   ["--mode", "classic", "--fused"]],
                         ids=["per-frame", "fused", "fused-classic"])
def test_collide_demo_writes_the_gif(tmp_path, capsys, extra):
    out = tmp_path / "collide.gif"
    collide_demo.main(["--out", str(out), "--frames", "3",
                       "--steps-per-frame", "1", "--n1", "300", "--n2",
                       "100", "--width", "120", "--height", "40",
                       "--device", "cpu", *extra])
    n, raw = _gif_frames(out)
    assert n == 3 and len(raw) > 900
    assert f"wrote {out}" in capsys.readouterr().out


@pytest.mark.parametrize("steps,every,flags", [
    (20, 8, ["--solver", "allpairs", "--integrator", "kdk_reuse", "--dt",
             "1e-4"]),
    (3, 2, ["--solver", "bh", "--theta", "0.4"]),
    (20, 8, ["--solver", "pm", "--integrator", "kdk_reuse", "--mesh-level",
             "8", "--mesh-band", "32", "--mesh-split", "3.0",
             "--mesh-rescue-k", "8", "--mesh-every", "2", "--heavy-cap", "2",
             "--dt", "1e-4"]),
], ids=["allpairs", "bh", "pm"])
def test_drift_benchmark_prints_its_json_lines(tmp_path, capsys, steps, every,
                                               flags):
    ckpt = tmp_path / "drift.npz"
    result = drift_benchmark.main(
        ["--n", "200", "--steps", str(steps), "--report-every", str(every),
         "--checkpoint", str(ckpt), "--device", "cpu", *flags])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# E0=") and "n=200" in lines[0]
    reports = [json.loads(x) for x in lines[1:]]
    assert [r["step"] for r in reports[:-1]] == [
        *range(every, steps, every), steps]
    assert set(reports[0]) == {"step", "energy_drift", "Lz_drift",
                               "elapsed_s"}
    last = reports[-1]
    assert set(last) == {"metric", "value", "unit"}
    assert last["unit"] == "relative" and f"over {steps} steps" in last["metric"]
    assert f"solver={flags[1]}" in last["metric"]
    assert last["value"] == result["value"]
    assert np.isfinite(result["value"]) and np.isfinite(result["Lz_drift"])
    if "--dt" in flags:     # 20 steps at dt = 1e-4 barely move the energy
        assert result["value"] < 1e-3 and result["Lz_drift"] < 1e-3
    state, params, extra = tcheckpoint.load(ckpt, device="cpu")
    assert int(state.step) == steps and int(state.n_alive()) == 200
    assert params.merge_min_dist == 0.0
    assert set(extra) == {"e0", "l0"}


def test_interactive_needs_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib is required"):
        interactive.main(["--device", "cpu"])


def test_interactive_ticks_headless(monkeypatch):
    """The window's callbacks on the Agg canvas: three ticks with the key,
    mouse and wheel bindings fired in between."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.animation
    import matplotlib.pyplot as plt
    from matplotlib.backend_bases import KeyEvent, MouseEvent

    ticks = []
    monkeypatch.setattr(matplotlib.animation, "FuncAnimation",
                        lambda fig, func, **kw: ticks.append((fig, func)))

    def show():
        fig, tick = ticks[0]
        ax = fig.axes[0]
        canvas = fig.canvas

        def key(k):
            canvas.callbacks.process("key_press_event",
                                     KeyEvent("key_press_event", canvas, k))

        def mouse(name, x, y, button=None, step=0):
            px, py = ax.transData.transform((x, y))
            canvas.callbacks.process(
                name, MouseEvent(name, canvas, px, py, button=button,
                                 step=step))

        im, txt = tick(0)
        first = np.array(im.get_array())
        assert first.shape == (40, 120, 3) and first.sum() > 0
        count0 = int(txt.get_text().split("Bodies count = ")[1].split()[0])
        assert 200 < count0 <= 255              # 204 + 51, less the merged
        for k in ("d", "x", "p", "right", "c"):
            key(k)
        mouse("scroll_event", 60, 20, step=1)
        mouse("button_press_event", 30, 10, button=1)
        mouse("motion_notify_event", 40, 12)
        tick(1)                                 # drag preview drawn
        mouse("button_release_event", 40, 12, button=1)
        mouse("button_press_event", 80, 30, button=3)
        mouse("button_release_event", 82, 30, button=3)
        im, txt = tick(2)
        text = txt.get_text()
        assert "Debug mode [D] = True" in text and "Theta [Z/X] = 0.35" in text
        assert "Bodies count = 512" in text     # cloud + disk fill capacity
        key(" ")
        mouse("button_press_event", 10, 10, button=2)   # clear
        im, txt = tick(3)
        assert "Bodies count = 0" in txt.get_text()
        assert np.array(im.get_array()).sum() == 0
        key("escape")

    monkeypatch.setattr(plt, "show", show)
    interactive.main(["--device", "cpu", "--solver", "bh", "--capacity",
                      "512", "--width", "120", "--height", "40",
                      "--steps-per-frame", "1"])
    assert len(ticks) == 1
