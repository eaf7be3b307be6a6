"""Per cent of the card's busy time in a traced training window taken by the
operations launched inside the program's ``train.update`` spans
(``apply_gradients``: the clip, AdamW and the EMA), from the exported
torch.profiler trace (``harness/program_spans.py``)."""
from benchmark.harness import program_spans

LAYER = "train step"
UNIT = "%"
SOURCE = "program_span"
MOVES = "train_samples_per_s"
BETTER = "lower"


def read(obs):
    return program_spans.launched_share(obs, "train", "train.update")
