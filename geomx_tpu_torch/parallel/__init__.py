"""Attention building blocks of the flagship transformer: the
single-device attention, and sequence parallelism over a mesh's ``sp``
axis (ring attention and Ulysses), run single-controller."""

from geomx_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from geomx_tpu_torch.parallel.ring_attention import (  # noqa: F401
    dense_attention, fast_dense_attention, ring_attention)
from geomx_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
