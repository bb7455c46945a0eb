"""Parallelism over a single-controller mesh: the mesh and its
collectives, data parallelism (``dp``), tensor and expert parallelism
(in the flagship transformer), sequence parallelism (ring attention and
Ulysses), the GPipe pipeline (``pp``), the int8 quantized all-reduce and
top-k MoE routing."""

from geomx_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, named_sharding)
from geomx_tpu_torch.parallel.quantized_allreduce import (  # noqa: F401
    make_party_step_quantized, quantized_psum_mean)
from geomx_tpu_torch.parallel.moe import (  # noqa: F401
    expert_capacity, moe_ffn_topk, topk_dispatch_combine)
from geomx_tpu_torch.parallel.ring_attention import (  # noqa: F401
    dense_attention, fast_dense_attention, ring_attention)
from geomx_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
