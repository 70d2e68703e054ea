"""The short range's share of its roofline: the bound of the slice's
passes (the ordered pairs with both bodies alive and with mass within 2a,
counted by a plain cell list on the slice's first state, at 21 flops a
pair) over the device time of the kernels below, in %."""

from nbody_bench import readers

# ops.band's kernel, and ops.mesh's rescue pair, selection, union and
# block-box kernels
PATTERNS = ("band_kernel", "rescue_kernel", "select_kernel",
            "unions_kernel", "block_boxes_kernel")


def read(ctx):
    return readers.roofline_pct(ctx, PATTERNS, readers.short_range_work)
