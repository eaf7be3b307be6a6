"""Per cent of a traced generation window in which the card is idle in a gap
whose midpoint lies inside one of the program's ``denoiser.forward`` spans: the
host's time between the denoiser's own launches, from the exported
torch.profiler trace (``harness/program_spans.py``)."""
from benchmark.harness import program_spans

LAYER = "whole model"
UNIT = "%"
SOURCE = "program_span"
MOVES = "motions_per_s"
BETTER = "lower"


def read(obs):
    return program_spans.idle_inside(obs, "generate", "denoiser.forward")
