"""CNN preset: ``cnn_p3`` == ``cnn --p3`` — P3: priority-based parameter
propagation.

    python -m geomx_tpu_torch.examples.cnn_p3 [cnn flags ...]
"""

import sys

from geomx_tpu_torch.examples._wrapper import run

FLAGS = "--p3"

if __name__ == "__main__":
    sys.exit(run(FLAGS))
