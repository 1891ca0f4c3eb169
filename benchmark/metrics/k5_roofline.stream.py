"""K5 (csrc/cross_attention.cu, Int8Packed at one query: int8
cross-attention of the active slot rows) in the continuous step: the least
time of the work it did in the step chunks wholly inside the traced
stretch, over its device time there. The work: each token generated attends
over its window's real audio positions, 50 a second (costmodel.k5_cost)."""

from benchmark import costmodel as cm
from benchmark.trace import kernel_seconds

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "updates_per_s"
PATTERN = r"cross_attention_kernel<.*Int8Packed, 1>"


def read(run):
    if run.kind != "stream" or not run.trace:
        return None
    secs, ids = kernel_seconds(run.trace["spans"], "step", PATTERN)
    steps = run.data["steps"]
    work = cm.Cost()
    for n in ids:
        work = work + cm.k5_cost(run.dims, steps[n]["tokens"], steps[n]["pos_tokens"])
    if secs <= 0 or work.least_s() <= 0:
        return None
    return 100.0 * work.least_s() / secs
