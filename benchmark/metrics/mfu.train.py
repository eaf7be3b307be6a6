"""The operations of every step of a traced training window (the forward and its
backward, three times the forward, nothing recomputed) over the window's length
times the peak of the cell's dtype, per cent."""
from benchmark.harness import readers

LAYER = "train step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"
BETTER = "higher"


def read(obs):
    return readers.mfu(obs, "train")
