"""setup_s: seconds from the runner's start (before ``import torch``) to
the first timed call: the imports, the CUDA context, the kernels loaded
(built, in the first run of a checkout), the seeded pool made on the
device, and every shape of the cell warmed (captured, in replay cells).
"""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
