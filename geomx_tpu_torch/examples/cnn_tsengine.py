"""CNN preset: ``cnn_tsengine`` == ``cnn --tsengine --tsengine-inter`` —
TSEngine overlay dissemination, in the party and over the WAN.

    python -m geomx_tpu_torch.examples.cnn_tsengine [cnn flags ...]
"""

import sys

from geomx_tpu_torch.examples._wrapper import run

FLAGS = "--tsengine --tsengine-inter"

if __name__ == "__main__":
    sys.exit(run(FLAGS))
