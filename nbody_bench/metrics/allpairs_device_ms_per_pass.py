"""Device ms an all-pairs pass: the operations launched in the program's
``allpairs`` phases (the dead masses zeroed, ``csrc/allpairs.cu``'s
kernel, the scale by G), over the ``allpairs`` marks in the traced slice;
each launch is matched with its device operation in stream order."""

from nbody_bench import allpairs_work


def read(ctx):
    got = allpairs_work.device_s(ctx)
    if got is None:
        return None
    spent, marks = got
    return 1e3 * spent / marks
