"""CNN preset: ``cnn_hfa`` == ``cnn --hfa`` — HFA: hierarchical frequency
aggregation (local steps between weight syncs).

    python -m geomx_tpu_torch.examples.cnn_hfa [cnn flags ...]
"""

import sys

from geomx_tpu_torch.examples._wrapper import run

FLAGS = "--hfa"

if __name__ == "__main__":
    sys.exit(run(FLAGS))
