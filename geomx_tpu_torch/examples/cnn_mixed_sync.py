"""CNN preset: ``cnn_mixed_sync`` == ``cnn --sync mixed --optimizer
dcasgd`` — mixed sync: an asynchronous global tier with DC-ASGD.

    python -m geomx_tpu_torch.examples.cnn_mixed_sync [cnn flags ...]
"""

import sys

from geomx_tpu_torch.examples._wrapper import run

FLAGS = "--sync mixed --optimizer dcasgd"

if __name__ == "__main__":
    sys.exit(run(FLAGS))
