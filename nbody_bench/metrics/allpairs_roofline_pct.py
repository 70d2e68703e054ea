"""The all-pairs pass's share of its roofline: the bound of the slice's
passes (each the alive targets by the alive sources of the slice's first
state at 13 flops a pair, :mod:`nbody_bench.allpairs_work`; a kdk_reuse
call runs one pass more than its steps) over the device time of the
operations launched in the program's ``allpairs`` phases, in %."""

from nbody_bench import allpairs_work, readers, work


def read(ctx):
    got = allpairs_work.device_s(ctx)
    if got is None or ctx.slice_state is None:
        return None
    w = allpairs_work.pass_work(ctx)
    bound = readers.passes(ctx) * work.bound_s(w["flops"], w["bytes"])
    return 100.0 * bound / got[0]
