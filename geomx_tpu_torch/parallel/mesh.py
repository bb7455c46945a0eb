"""A device mesh for one controlling process — the port of the JAX
package's ``parallel/mesh.py`` (``make_mesh``).

JAX's ``shard_map`` is a single-controller program: one process drives
every device of the mesh.  The port keeps that form: a :class:`Mesh`
names its axes and holds one ``torch.device`` per rank, and the code
that runs over an axis (``ring_attention``, ``ulysses_attention``) loops
over the ranks in one process, moving a rank's shard to another rank's
device with ``.to(device)``.  Ranks may share a device: several ranks on
one card (or on the CPU, as the tests run them) stand in for JAX's
virtual CPU devices, and a move between them is a no-op.

Axis conventions (the JAX package's): ``dp`` data parallel, ``tp``
tensor parallel, ``sp`` sequence parallel, ``ep`` expert parallel,
``pp`` pipeline stages.  ``named_sharding`` (placing whole tensors over
dp/tp) comes with those axes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]


class Mesh:
    """Ordered axis names → sizes, and one device per rank.  Ranks are
    numbered row-major over the axes in their order, as JAX reshapes its
    device array: the last axis varies fastest."""

    def __init__(self, axes: Dict[str, int], devices: Sequence[DeviceLike]):
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in axes.items()}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        if len(devices) != self.size:
            raise ValueError(f"mesh of {self.size} ranks given "
                             f"{len(devices)} devices")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def coords(self, rank: int) -> Dict[str, int]:
        """The rank's coordinate on each axis."""
        out, rest = {}, rank
        for name in reversed(self.axis_names):
            rest, out[name] = divmod(rest, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank(self, **coords: int) -> int:
        """The rank at ``coords`` (axes left out are at 0)."""
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + int(coords.get(name, 0))
        return r

    def device(self, **coords: int) -> torch.device:
        return self.devices[self.rank(**coords)]

    def axis_devices(self, axis: str, **fixed: int) -> List[torch.device]:
        """The devices along ``axis``, the other axes at ``fixed`` (0 where
        not given), in axis order."""
        return [self.device(**{**fixed, axis: i})
                for i in range(self.shape[axis])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Build a :class:`Mesh` with the given axis sizes, e.g.
    ``{"dp": 1, "sp": 4, "tp": 1}``.  ``devices`` defaults to every
    visible CUDA card; an explicit list may name one device several
    times (several ranks on one card, or ``["cpu"] * 4``).  Takes the
    first ``prod(sizes)`` devices and raises when there are fewer."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = math.prod(int(v) for v in axes.values())
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    return Mesh(axes, list(devices)[:n])
