"""CNN preset: ``cnn_fp16`` == ``cnn --compression fp16`` — fp16 WAN
compression.

    python -m geomx_tpu_torch.examples.cnn_fp16 [cnn flags ...]
"""

import sys

from geomx_tpu_torch.examples._wrapper import run

FLAGS = "--compression fp16"

if __name__ == "__main__":
    sys.exit(run(FLAGS))
