"""CNN preset: ``cnn_mpq`` == ``cnn --compression mpq`` — MPQ:
mixed-precision quantization (BSC for large keys, fp16 for small).

    python -m geomx_tpu_torch.examples.cnn_mpq [cnn flags ...]
"""

import sys

from geomx_tpu_torch.examples._wrapper import run

FLAGS = "--compression mpq"

if __name__ == "__main__":
    sys.exit(run(FLAGS))
