"""CNN preset: ``cnn_bsc`` == ``cnn --compression bsc`` — Bi-Sparse
compression (DGC momentum and top-k on both tiers).

    python -m geomx_tpu_torch.examples.cnn_bsc [cnn flags ...]
"""

import sys

from geomx_tpu_torch.examples._wrapper import run

FLAGS = "--compression bsc"

if __name__ == "__main__":
    sys.exit(run(FLAGS))
