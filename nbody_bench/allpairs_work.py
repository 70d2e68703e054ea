"""What the all-pairs metrics read: the work of one exact force pass and
the device time of the program's ``allpairs`` phases.

:func:`pair_work` is a frozen copy of the program's count
(``forces.pair_work``), so a change to the program cannot move the
yardstick; :func:`pass_work` applies it to the pairs the data needs, the
alive targets by the alive sources of the slice's first state, so a
kernel that stops walking the empty and absorbed slots reads higher and
stays within its bound.
"""

from __future__ import annotations

from nbody_bench import spans

PHASE = "allpairs"
# flops a pair from the plain formula, rsqrt and divide one operation each:
# d (dim), r² (2 dim), rsqrt 1, /r² 1, ×m 1, accumulate (2 dim)
PAIR_FLOPS = {2: 13, 3: 18}
_F32 = 4


def pair_work(nt: int, ns: int, dim: int) -> dict:
    """Pairs, flops and bytes of ``nt`` targets by ``ns`` sources: targets,
    sources and masses read once, the accelerations written once."""
    pairs = nt * ns
    return dict(pairs=pairs, flops=pairs * PAIR_FLOPS[dim],
                bytes=_F32 * (2 * nt * dim + ns * (dim + 1)))


def pass_work(ctx) -> dict:
    """One pass's work on the slice's first state: the alive bodies as
    targets and as sources."""
    alive = int(ctx.slice_state[3].sum())
    return pair_work(alive, alive, ctx.slice_state[0].shape[1])


def device_s(ctx):
    """(device seconds of the operations launched in ``allpairs`` phases,
    the ``allpairs`` marks that end in the slice); None where the run has
    no trace or the program marks no such phase."""
    got = spans._traced(ctx)
    if got is None:
        return None
    tr, phases = got
    marks = spans.count_in_slice(tr, phases, PHASE)
    split = spans.device_by_layer(tr, phases)
    if split is None or marks == 0 or split.get(PHASE, 0.0) <= 0:
        return None
    return split[PHASE], marks
