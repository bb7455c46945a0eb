"""CNN preset: ``cnn_esync`` == ``cnn --esync`` — ESync: the party's state
server balances each worker's local steps.

    python -m geomx_tpu_torch.examples.cnn_esync [cnn flags ...]
"""

import sys

from geomx_tpu_torch.examples._wrapper import run

FLAGS = "--esync"

if __name__ == "__main__":
    sys.exit(run(FLAGS))
