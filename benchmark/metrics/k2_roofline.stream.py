"""K2 (csrc/int8_matmul.cu, int8 weight-only decoder linears) in the
continuous step: the least time of the work it did in the step chunks
wholly inside the traced stretch, over its device time there. The work:
each decode step that produced a token reads every decoder weight matrix
once; each token generated is one row through each linear (costmodel.k2_cost).
A kernel is placed in a chunk by the host op that launched it."""

from benchmark import costmodel as cm
from benchmark.trace import kernel_seconds

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "updates_per_s"
PATTERN = r"\bint8_matmul_kernel"


def read(run):
    if run.kind != "stream" or not run.trace:
        return None
    secs, ids = kernel_seconds(run.trace["spans"], "step", PATTERN)
    steps = run.data["steps"]
    spc = run.data["steps_per_chunk"]
    work = cm.Cost()
    for n in ids:
        s = steps[n]
        work = work + cm.k2_cost(run.dims, min(spc, s["tokens"]), s["tokens"])
    if secs <= 0 or work.least_s() <= 0:
        return None
    return 100.0 * work.least_s() / secs
