"""Per cent of the attention core's score tiles that its blocks computed in a
traced generation window, against a walk over every key: the key tiles past
each batch element's last live key are skipped (the program's counter,
``harness/key_tiles.py``)."""
from benchmark.harness import key_tiles

LAYER = "attention core"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "motions_per_s"
BETTER = "lower"


def read(obs):
    return key_tiles.walked_share(obs, "generate")
