"""The least time of the adaptive LayerNorm work of a traced generation window
(DiT's ``adaln`` layer of ``counts/dit.py``: its bytes at the memory's peak)
over the device time of the ``adaln_`` kernels, per cent."""
from benchmark.harness import readers

LAYER = "modulation"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "motions_per_s"
BETTER = "higher"


def read(obs):
    return readers.roofline(obs, "generate", "adaln", r"adaln_")
