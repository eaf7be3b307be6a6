"""Per cent of a traced training window in which no kernel, copy or set ran on the
card: the union of their intervals from torch.profiler, not their sum."""
from benchmark.harness import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"
BETTER = "lower"


def read(obs):
    return readers.idle_share(obs, "train")
