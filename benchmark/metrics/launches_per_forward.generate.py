"""Kernels launched on the card in a traced generation window over the denoiser
forwards that the benchmark's hooks counted in it."""
from benchmark.harness import readers

LAYER = "sampler loop"
UNIT = "kernels"
SOURCE = "device_trace"
MOVES = "motions_per_s"
BETTER = "lower"


def read(obs):
    return readers.launches_per(obs, "generate", "mdm.forward")
