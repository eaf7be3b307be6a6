"""Per cent of the card's busy time in a traced generation window taken by the
operations launched inside the program's ``sample.step`` spans and outside its
``denoiser.forward`` spans: the sampler's own arithmetic (the guidance mix, the
posterior, the draws), from the exported torch.profiler trace
(``harness/program_spans.py``)."""
from benchmark.harness import program_spans

LAYER = "sampler loop"
UNIT = "%"
SOURCE = "program_span"
MOVES = "motions_per_s"
BETTER = "lower"


def read(obs):
    return program_spans.launched_share(obs, "generate", "sample.step", ("denoiser.forward",))
