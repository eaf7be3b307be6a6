"""The least time of the products, forward and backward, that the port's product
kernels run in a traced training window over the device time of those kernels,
per cent."""
from benchmark.harness import readers

LAYER = "products"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"
BETTER = "higher"


def read(obs):
    return readers.roofline(obs, "train", "products", readers.PRODUCTS)
