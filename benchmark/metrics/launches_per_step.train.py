"""Kernels launched on the card in a traced training window over its steps."""
from benchmark.harness import readers

LAYER = "train step"
UNIT = "kernels"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"
BETTER = "lower"


def read(obs):
    return readers.launches_per(obs, "train", None)
