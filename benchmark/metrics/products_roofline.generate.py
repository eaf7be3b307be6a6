"""The least time of the products that the port's product kernels run in a traced
generation window (operations over the dtype's peak or bytes over the memory's,
the larger) over the device time of those kernels, per cent."""
from benchmark.harness import readers

LAYER = "products"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "motions_per_s"
BETTER = "higher"


def read(obs):
    return readers.roofline(obs, "generate", "products", readers.PRODUCTS)
