"""K2 (csrc/int8_matmul.cu, int8 weight-only decoder linears) in the window
batches wholly inside the traced stretch: the least time of their decode
steps (each step reads every decoder weight matrix once; each token after
the first of a window is one row through each linear; costmodel.k2_cost),
over K2's device time there (prefill calls included, which add time and
no counted work)."""

from benchmark import costmodel as cm
from benchmark.trace import kernel_seconds

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "rtfx"
PATTERN = r"\bint8_matmul_kernel"


def read(run):
    if run.kind != "files" or not run.trace:
        return None
    secs, ids = kernel_seconds(run.trace["spans"], "batch", PATTERN)
    batches = run.data["batches"]
    work = cm.Cost()
    for n in ids:
        served = [len(s) for s in batches[n]["served"]]
        steps = max(max(served, default=0) - 1, 0)
        tokens = sum(max(s - 1, 0) for s in served)
        work = work + cm.k2_cost(run.dims, steps, tokens)
    if secs <= 0 or work.least_s() <= 0:
        return None
    return 100.0 * work.least_s() / secs
