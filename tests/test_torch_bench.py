"""tpu_nbody_torch.bench on the CPU: its configuration against the JAX
bench's (``bench.py`` at the repo root, loaded by path and stopped at its
Engine), one JSON line per solver with a computed force error, no CPU
fallback, the phase table's work counts, its rows (CUDA events stood in by
a host clock, since only the card times phases), the Barnes–Hut pair tally,
and the refusal of a retune inside a timed repeat."""

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_nbody.engine as jengine
from tpu_nbody_torch import accuracy, bench
from tpu_nbody_torch import state as tstate
from tpu_nbody_torch.config import Params, SimConfig
from tpu_nbody_torch.engine import Engine
from tpu_nbody_torch.models import scenes
from tpu_nbody_torch.ops import band

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--small", "--device", "cpu", "--n", "4096", "--steps", "2",
         "--repeats", "1"]
JAX_ONLY = {"bh_stream_split", "bh_allow_twin_traversal"}


class _Stop(Exception):
    pass


def _recorder(seen):
    class Stub:
        def __init__(self, cfg, params, **kw):
            seen.append((cfg, params, kw))
            raise _Stop
    return Stub


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench_script",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("size", [[], ["--small"]], ids=["full", "small"])
@pytest.mark.parametrize("solver", ["pm", "bh", "allpairs"])
def test_bench_config_matches_jax_bench(monkeypatch, solver, size):
    """The port's bench builds its Engine from the SimConfig, Params and
    keywords the JAX bench builds its own from, field for field (less the
    JAX package's two TPU workarounds)."""
    argv = ["--solver", solver, *size]
    jseen, tseen = [], []
    monkeypatch.setattr(jengine, "Engine", _recorder(jseen))
    monkeypatch.setattr(bench, "Engine", _recorder(tseen))
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    with pytest.raises(_Stop):      # after its retries and worker waits
        _jax_bench().main()
    with pytest.raises(_Stop):
        bench.main([*argv, "--device", "cpu"])
    (jcfg, jparams, jkw), (tcfg, tparams, tkw) = jseen[0], tseen[0]

    jfields = {f.name for f in dataclasses.fields(jcfg)}
    tfields = {f.name for f in dataclasses.fields(tcfg)}
    assert jfields - tfields == JAX_ONLY and tfields <= jfields
    for name in sorted(tfields):
        jv, tv = getattr(jcfg, name), getattr(tcfg, name)
        if isinstance(jv, (list, tuple)):
            jv, tv = tuple(jv), tuple(tv)
        assert jv == tv, name
    assert tcfg == bench.bench_config(
        20_000 if size else 1_000_000, solver, bool(size))
    for f in dataclasses.fields(tparams):
        assert float(np.asarray(getattr(jparams, f.name))) == \
            getattr(tparams, f.name), f.name
    assert tkw.pop("device") == torch.device("cpu")
    assert tkw == jkw == dict(solver=solver, integrator="kdk_reuse", seed=3)


@pytest.mark.parametrize("solver", ["pm", "bh", "allpairs"])
def test_one_json_line_with_computed_force_error(capsys, solver):
    rep = bench.main([*SMALL, "--solver", solver])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    assert line["unit"] == "bodies/s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / bench.BASELINE_UPDATES_PER_SEC, abs=0.0051)
    assert "device=cpu" in line["metric"]
    assert f"solver={solver}" in line["metric"]
    assert rep["phases"] is None            # phases are timed on the card

    eng = rep["engine"]
    again = accuracy.sampled_force_error(
        eng.state, eng.cfg, eng.params, bench.SAMPLES_SMALL,
        torch.Generator().manual_seed(bench.SEED), solver=solver,
        caps=eng.caps if solver == "bh" else None)
    assert again == rep["force_error"]
    assert again["samples"] == bench.SAMPLES_SMALL
    assert (f"force err mean {again['mean']:.2g} p99 {again['p99']:.2g}"
            in line["metric"])
    if solver == "bh":
        assert "theta=0.5" in line["metric"]
    if solver == "allpairs":
        assert "exact" in line["metric"]


def test_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--small", "--n", "4096", "--steps", "1"])


@pytest.mark.parametrize("small", [False, True])
def test_phase_work_counts(small):
    cfg = bench.bench_config(1_000_000 if not small else 20_000, "pm", small)
    n = 1_000_000 if not small else 20_000
    work = bench.phase_work(cfg, n)
    assert set(work) == {"sort", "deposit", "fft", "fd", "interp",
                         "band", "rescue_select", "rescue_pairs", "merge",
                         "kernel_hats"}
    assert work["band"] == band.pair_work(n, cfg.mesh_band, cfg.mesh_switch)
    S, k = cfg.mesh_band, cfg.mesh_rescue
    assert work["rescue_pairs"]["pairs"] == n * k * S
    assert work["rescue_pairs"]["flops"] == \
        n * k * S * band._PAIR_FLOPS["poly4"]
    blocks = -(-n // S)
    # the selection's union tests, then 32 box tests a near group
    assert work["rescue_select"]["flops"] == 11 * blocks * -(-blocks // 32)
    near = bench.phase_work(cfg, n, select_groups=1000)["rescue_select"]
    assert near["flops"] == work["rescue_select"]["flops"] + 11 * 32 * 1000
    assert near["bytes"] == work["rescue_select"]["bytes"]
    for row in work.values():             # counted from shapes alone
        assert all(isinstance(v, (int, float)) and v >= 0
                   for v in row.values())
        assert row["bytes"] > 0
    assert bench.phase_work(cfg, n) == work
    # the merge scales with the heavy slots it tests every body against
    assert bench.phase_work(cfg, n, heavy_cap=128)["merge"]["flops"] == \
        2 * work["merge"]["flops"]
    # ... and with the heavies the data has, when fewer
    assert bench.phase_work(cfg, n, heavy_need=16)["merge"]["flops"] == \
        work["merge"]["flops"] // 4
    assert bench.phase_work(cfg, n, heavy_need=0)["merge"]["flops"] == 0
    # the interpolation reads the window cells the bodies touch, when given
    few = bench.phase_work(cfg, n, interp_cells=1000)["interp"]
    assert few["flops"] == work["interp"]["flops"]
    assert few["bytes"] < work["interp"]["bytes"]
    nw = 1 << cfg.mesh_level
    windows = 2 * (nw + 1) * ((cfg.mesh_ny or nw) + 1) * 4   # fx and fy
    assert work["interp"]["bytes"] - few["bytes"] == windows - 8 * 1000
    # the FD stencil: 16 flops a window cell, its 7 + ny kept potential
    # rows read at the nw + 7 columns it touches, the windows written
    ny = cfg.mesh_ny or nw
    assert work["fd"] == dict(flops=16 * (nw + 1) * (ny + 1),
                              bytes=(ny + 7) * (nw + 7) * 4 + windows)
    # the fresh pass's one deposit launch: the cells, then 4 products and
    # adds a body
    assert work["deposit"]["flops"] == (16 + 2 * 4) * n


class _HostEvent:
    """Stands in for torch.cuda.Event on the CPU (host clock)."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


PHASES = {
    "pm": ["hilbert sort (/8 steps)", "cells + deposit 4 taps (kernel)",
           "FFT convolution",
           "FD gradient (kernel)", "interpolation (kernel)",
           "band S=256 (kernel)", "rescue select k=4 (kernel)",
           "rescue pairs k=4 (kernel)", "merge (kernel)",
           "kernel hats (/2 steps)"],
    "bh": ["build", "groups", "lists", "evaluate (bh_pairs kernel)",
           "assemble"],
    "allpairs": ["all-pairs kernel (4096 x 4096 slots)"],
}
BODIES = {"pm": 4096, "bh": 1024, "allpairs": 4096}


@pytest.mark.parametrize("solver", ["pm", "bh", "allpairs"])
def test_phase_table_rows(monkeypatch, capsys, solver):
    """The table's control flow and rows on the CPU, CUDA events replaced
    by a host clock: every row has a bound and a share of it."""
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    n = BODIES[solver]
    eng = Engine(bench.bench_config(n, solver, True), Params.default(
        theta=0.5), solver=solver, integrator="kdk_reuse", device="cpu")
    eng.reset_default_scene(n1=n - n // 5, n2=n // 5)
    eng.step(1)
    card = dict(name="host clock", smi=None, power_limit="not read")
    rows = bench._phase_table(eng, 100.0, 2, sys.stderr, card)
    assert [r["name"] for r in rows] == PHASES[solver]
    for r in rows:
        assert r["ms"] > 0 and r["bound_ms"] > 0 and r["pct_of_bound"] > 0
        assert r["bound_by"] in ("bytes", "operations")
    err = capsys.readouterr().err
    assert "sum of phases" in err and "useful flops" in err
    if solver == "bh":
        assert "pairs evaluated" in err
    if solver == "pm":
        assert "walked by the rescue kernel" in err
    assert bench.print_phases(eng, 100.0, 2) is None     # not on the CPU
    assert "not measured without a card" in capsys.readouterr().err


def test_phase_work_takes_the_rescue_pairs():
    """The rescue pair row counts the pairs the caller says the data needs
    (``band.rescue_cutoff_pairs``), the selection row the rows and boxes
    it writes."""
    cfg = bench.bench_config(1_000_000, "pm", False)
    n = 1_000_000
    work = bench.phase_work(cfg, n)
    near = bench.phase_work(cfg, n, rescue_pairs=274_947_802)["rescue_pairs"]
    assert near["pairs"] == 274_947_802
    assert near["flops"] == 21 * 274_947_802
    assert near["bytes"] == work["rescue_pairs"]["bytes"]
    blocks = -(-n // cfg.mesh_band)
    assert work["rescue_select"]["bytes"] == (
        n * 13 + blocks * (cfg.mesh_band * 3 + 4) * 4
        + blocks * cfg.mesh_rescue * 13)


@pytest.mark.parametrize("traversal,kernel", [("dense", "bh_pairs"),
                                               ("hier", "bh_hier")])
def test_bh_phase_rows_follow_the_route(monkeypatch, capsys, traversal,
                                        kernel):
    """The evaluate row names the kernel of the pass's traversal; a hier
    pass has no flatten row and reports the pairs its kernel walks."""
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    cfg = dataclasses.replace(bench.bench_config(1024, "bh", True),
                              bh_traversal=traversal)
    assert bench.bh_kernel(cfg) == kernel
    eng = Engine(cfg, Params.default(theta=0.5), solver="bh",
                 integrator="kdk_reuse", device="cpu")
    eng.reset_default_scene(n1=820, n2=204)
    eng.step(1)
    card = dict(name="host clock", smi=None, power_limit="not read")
    rows = bench._phase_table(eng, 100.0, 2, sys.stderr, card)
    assert [r["name"] for r in rows] == [
        "build", "groups", "lists", f"evaluate ({kernel} kernel)",
        "assemble"]
    err = capsys.readouterr().err
    assert ("walked by the bh_hier kernel" in err) == (kernel == "bh_hier")
    assert bench.bh_kernel(bench.bench_config(1 << 20, "bh", False)) == \
        "bh_hier"


class _Tally:
    def __init__(self):
        self.padded, self.needed = 0, []

    def __call__(self, name):
        pass

    def pairs(self, padded, needed):
        self.padded += padded
        self.needed.append(needed)


@pytest.mark.parametrize("traversal", ["dense", "hier"])
def test_bh_pair_tally(traversal):
    """With theta -> 0 every cell opens, so each body needs every alive body
    as a direct partner: n² pairs. At theta = 0.5 both traversals need the
    same pairs (their interaction sets are identical)."""
    g = torch.Generator().manual_seed(0)
    p, v, m = scenes.default_two_disk_scene(g, n1=800, n2=200)
    st = tstate.from_arrays(p, v, m, 1024, device="cpu")
    n = int(st.n_alive())
    cfg = SimConfig(capacity=1024, group_size=64, bh_traversal=traversal,
                    bh_hier_sizes=(8, 2, 1))
    needed = {}
    for theta in (1e-3, 0.5):
        t = _Tally()
        accuracy.fitted_bh_pass(st.pos, st.mass, st.alive, cfg,
                                Params.default(theta=theta), probe=t)
        needed[theta] = int(torch.stack(t.needed).sum())
        assert t.padded >= needed[theta] > 0
    assert needed[1e-3] == n * n
    assert needed[0.5] < n * n
    if traversal == "hier":
        dense = _Tally()
        accuracy.fitted_bh_pass(st.pos, st.mass, st.alive,
                                dataclasses.replace(cfg,
                                                    bh_traversal="dense"),
                                Params.default(theta=0.5), probe=dense)
        assert int(torch.stack(dense.needed).sum()) == needed[0.5]


def test_a_retune_inside_a_timed_repeat_raises():
    class Growing:
        device = torch.device("cpu")
        caps, merge_heavy_cap = "caps", 64

        def step(self, n):
            self.merge_heavy_cap *= 2

    with pytest.raises(RuntimeError, match="retune ran inside"):
        bench._timed_repeats(Growing(), 2, 3)

    class Steady(Growing):
        def step(self, n):
            pass

    dev_ms, host_ms = bench._timed_repeats(Steady(), 2, 3)
    assert dev_ms is None and len(host_ms) == 3
