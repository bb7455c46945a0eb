"""CNN preset: ``cnn_dgt`` == ``cnn --dgt 1`` — DGT: differential gradient
transmission, important blocks reliable and the rest over lossy UDP.

    python -m geomx_tpu_torch.examples.cnn_dgt [cnn flags ...]
"""

import sys

from geomx_tpu_torch.examples._wrapper import run

FLAGS = "--dgt 1"

if __name__ == "__main__":
    sys.exit(run(FLAGS))
