"""The operations of every forward of a traced generation window (the text tower
and the denoiser, counted from the shapes by benchmark/counts/flops.py) over
the window's length times the peak of the cell's dtype, per cent."""
from benchmark.harness import readers

LAYER = "whole model"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "motions_per_s"
BETTER = "higher"


def read(obs):
    return readers.mfu(obs, "generate")
