"""What the metric files (``metrics/<name>.py``) share: each file's
``read(ctx)`` calls one of these with its own arguments and returns a
number, or None where the run has nothing to read (no trace, no slice)."""

from __future__ import annotations

from nbody_bench import stats, work


def _steps(ctx) -> int:
    return ctx.window.slice_calls * ctx.window.steps_per_call


def _traced(ctx) -> bool:
    """A slice was traced and the card ran something in it."""
    tr = ctx.trace
    return tr is not None and bool(tr.marks) and bool(tr.device_in_slice())


def idle_pct(ctx):
    """The device's idle share of the traced slice, in %."""
    tr = ctx.trace
    if not _traced(ctx):
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())


def device_ops_per_step(ctx):
    """Device operations (kernels, memsets, copies) in the slice a step."""
    tr = ctx.trace
    if not _traced(ctx):
        return None
    return len(tr.device_in_slice()) / _steps(ctx)


def enqueue_ms_per_step(ctx):
    """Host ms from each traced call's start to the launch of its last
    device operation, summed, a step."""
    from nbody_bench import trace

    if not _traced(ctx):
        return None
    return 1e3 * trace.enqueue_s(ctx.trace) / _steps(ctx)


def matching_s(ctx, patterns) -> float:
    """Device seconds in the slice of the operations whose name holds one
    of ``patterns``."""
    return sum(s.end - s.start for s in ctx.trace.device_in_slice()
               if any(p in s.name for p in patterns))


def passes(ctx) -> int:
    """Force passes in the slice: a kdk_reuse call runs one more than its
    steps (its seed)."""
    extra = 1 if ctx.config["integrator"] == "kdk_reuse" else 0
    return ctx.window.slice_calls * (ctx.window.steps_per_call + extra)


def _geometry(ctx):
    c, s = ctx.config, ctx.config["sim_config"]
    origin, side = work.root(c["world_w"], c["world_h"])
    return work.pm_geometry(origin, side, s["mesh_level"], s["mesh_ny"],
                            s["mesh_split"])


def _memo(ctx, key, fn):
    """``fn()`` once a run: several metrics read the same count."""
    memo = ctx.__dict__.setdefault("memo", {})
    if key not in memo:
        memo[key] = fn()
    return memo[key]


def short_range_work(ctx) -> dict:
    """One pass's short-range work on the slice's first state: the
    ordered pairs within 2a."""
    return _memo(ctx, "short", lambda: _short_range_work(ctx))


def long_range_work(ctx) -> dict:
    """One fresh mesh pass's work on the slice's first state."""
    return _memo(ctx, "long", lambda: _long_range_work(ctx))


def _short_range_work(ctx) -> dict:
    pos, _, mass, alive = ctx.slice_state
    a = _geometry(ctx)[5]
    pairs = work.pairs_within(pos, mass, alive, 2.0 * a)
    return work.short_range_pass(pairs, int(alive.sum()))


def _long_range_work(ctx) -> dict:
    pos, _, _, alive = ctx.slice_state
    nw, ny, _, _, h, _, morigin = _geometry(ctx)
    cells = work.cells_touched(pos, alive, morigin, h, nw, ny)
    return work.long_range_pass(int(alive.sum()), cells, nw, ny)


def stretches_s(ctx, first, last):
    """(stretches, device seconds) of the slice's stretches of the stream
    that run from an operation whose name holds ``first`` (with the memset
    just before it, where there is one) to the next one whose name holds
    ``last``: every operation between them counted, whatever its name."""
    ops = ctx.trace.device_in_slice()
    n, spent, i = 0, 0.0, 0
    while i < len(ops):
        if first not in ops[i].name:
            i += 1
            continue
        j = next((j for j in range(i, len(ops)) if last in ops[j].name),
                 None)
        if j is None:
            break
        lo = i - 1 if i > 0 and "Memset" in ops[i - 1].name else i
        spent += sum(s.end - s.start for s in ops[lo:j + 1])
        n += 1
        i = j + 1
    return n, spent


def roofline_pct(ctx, patterns, pass_work):
    """The bound of the slice's passes (``pass_work(ctx)`` each) over the
    device time of the operations matching ``patterns``, in %."""
    if not _traced(ctx) or ctx.slice_state is None:
        return None
    spent = matching_s(ctx, patterns)
    if spent <= 0:
        return None
    w = pass_work(ctx)
    return 100.0 * passes(ctx) * work.bound_s(w["flops"], w["bytes"]) / spent


def stretch_roofline_pct(ctx, first, last, pass_work):
    """The bound of one pass (``pass_work(ctx)``) times the stretches
    :func:`stretches_s` finds, over their device time, in %."""
    if not _traced(ctx) or ctx.slice_state is None:
        return None
    n, spent = stretches_s(ctx, first, last)
    if n == 0 or spent <= 0:
        return None
    w = pass_work(ctx)
    return 100.0 * n * work.bound_s(w["flops"], w["bytes"]) / spent


def mean_ms(values):
    return sum(values) / len(values) if values else None


def quantile(values, q):
    return stats.percentile(values, q) if values else None


