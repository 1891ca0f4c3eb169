"""Process start to the window's start: imports, the kernel library (its
nvcc build on a checkout's first run), weights, int8 quantization, warm-up
and, for streams, the pre-fill before the window."""

LAYER = "end to end"
UNIT = "s"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return run.setup_s
