"""Shared mechanism of the CNN presets (the port's counterparts of the
JAX package's ``examples/cnn_<feature>.py``): each preset puts its
flags before the caller's and runs ``examples.cnn.main`` (a flag the
caller gives wins: argparse keeps the last occurrence)."""

import sys
from typing import Optional


def run(flags: str, argv: Optional[list] = None) -> int:
    from geomx_tpu_torch.examples import cnn

    args = sys.argv[1:] if argv is None else list(argv)
    return cnn.main(flags.split() + args)
