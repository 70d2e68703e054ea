"""The long range's share of its roofline: the bound of a fresh mesh pass
(deposit, FFT convolution, FD gradient, interpolation at the cells the
bodies touch) over the device time of each pass's long range, in %.

A pass's long range is the stretch of the stream from ops.mesh's deposit
kernel (deposit.cu, with the memset before it that zeroes the block it
fills) to its interpolation kernel (interp.cu): every operation the
convolution launches in between (cuFFT's transforms, the pad, the
spectrum's multiply, the rows' cat, the copies) and fd.cu's gradient
count, whatever their names, so the time covers the work the bound
counts."""

from nbody_bench import readers


def read(ctx):
    return readers.stretch_roofline_pct(ctx, "deposit_kernel",
                                        "windows_kernel",
                                        readers.long_range_work)
