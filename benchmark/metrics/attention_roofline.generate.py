"""The least time of the attention that the port's attention core runs in a traced
generation window (the (query, key) pairs the masks leave) over the device time
of the attn_fwd kernels, per cent."""
from benchmark.harness import readers

LAYER = "attention core"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "motions_per_s"
BETTER = "higher"


def read(obs):
    return readers.roofline(obs, "generate", "attention", readers.ATTENTION)
