"""K1 (csrc/fused_attention.cu, the encoder's self-attention) in the window
batches wholly inside the traced stretch: the least time of their windows'
attention over the real audio positions (costmodel.k1_cost), over K1's
device time there."""

from benchmark import costmodel as cm
from benchmark.trace import kernel_seconds

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "rtfx"
PATTERN = r"fused_attention_kernel"


def read(run):
    if run.kind != "files" or not run.trace:
        return None
    secs, ids = kernel_seconds(run.trace["spans"], "batch", PATTERN)
    batches = run.data["batches"]
    work = cm.Cost()
    for n in ids:
        b = batches[n]
        for j in range(b["rows"]):
            work = work + cm.k1_cost(run.dims, b["real_s"][j])
    if secs <= 0 or work.least_s() <= 0:
        return None
    return 100.0 * work.least_s() / secs
