"""Per cent of the card's busy time in a traced generation window taken by the
operations launched inside the program's ``denoiser.condition`` spans (DiT's
timestep and text embedding and the product that gives every block's
modulation): the union of their intervals over the union of every
operation's, from the exported torch.profiler trace
(``harness/program_spans.py``)."""
from benchmark.harness import program_spans

LAYER = "modulation"
UNIT = "%"
SOURCE = "program_span"
MOVES = "motions_per_s"
BETTER = "lower"


def read(obs):
    return program_spans.launched_share(obs, "generate", "denoiser.condition")
