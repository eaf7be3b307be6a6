"""The least time of the attention, forward and backward, that the port's
attention core runs in a traced training window over the device time of the
attn_fwd and attn_bwd kernels, per cent."""
from benchmark.harness import readers

LAYER = "attention core"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"
BETTER = "higher"


def read(obs):
    return readers.roofline(obs, "train", "attention", readers.ATTENTION)
