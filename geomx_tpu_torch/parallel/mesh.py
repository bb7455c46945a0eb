"""A device mesh for one controlling process — the port of the JAX
package's ``parallel/mesh.py`` (``make_mesh``, ``named_sharding``) —
and the collectives that code running over its axes shares.

JAX's ``shard_map`` and GSPMD programs are single-controller: one
process drives every device of the mesh.  The port keeps that form: a
:class:`Mesh` names its axes and holds one ``torch.device`` per rank,
and the code that runs over an axis loops over the ranks in one
process, each rank's shard on that rank's device.  Ranks may share a
device: several ranks on one card (or on the CPU, as the tests run
them) stand in for JAX's virtual CPU devices, and a move between them
is a no-op.

Every cross-rank reduction is an explicit operation on per-rank
tensors, even where the ranks share a device.  The collectives take and
return lists of per-rank tensors along one axis, in rank order, and are
the port's counterparts of ``lax.psum`` (:func:`psum`, whose backward is
a psum too), ``lax.all_gather`` (:func:`all_gather`), ``lax.all_to_all``
(:func:`all_to_all`), ``lax.ppermute`` (:func:`ppermute`) and
``lax.axis_index`` (:func:`axis_index`).  A sum runs in rank order, so
its bits do not depend on where the ranks live.

:func:`named_sharding` places a whole tensor over mesh axes (the
counterpart of ``NamedSharding(mesh, PartitionSpec(*spec))``): its
:meth:`NamedSharding.shard` splits the tensor into per-rank shards on
the ranks' devices, differentiably — the gradient of a shard held by
several ranks is the explicit sum of their gradients, as the transpose
of a replicated input is a psum in JAX — and :meth:`NamedSharding.join`,
its transpose, puts shards back together, summing a piece's replicas.

Axis conventions (the JAX package's): ``dp`` data parallel, ``tp``
tensor parallel, ``sp`` sequence parallel, ``ep`` expert parallel
(aliased to ``tp``), ``pp`` pipeline stages.
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


def visible_cards() -> List[torch.device]:
    """Every visible CUDA card; raises RuntimeError without CUDA (a mesh
    of CPU ranks is asked for by name)."""
    from geomx_tpu_torch.core.platform import resolve_device

    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Build a :class:`Mesh` with the given axis sizes, e.g.
    ``{"dp": 1, "sp": 4, "tp": 1}``.  ``devices`` defaults to every
    visible CUDA card (:func:`visible_cards`); an explicit list may name
    one device several times (several ranks on one card, or
    ``["cpu"] * 4``).  Takes the first ``prod(sizes)`` devices and
    raises when there are fewer."""
    if devices is None:
        devices = visible_cards()
    n = math.prod(int(v) for v in axes.values())
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    return Mesh(axes, list(devices)[:n])


def axis_index(mesh: Mesh, axis: str, rank: int) -> int:
    """``lax.axis_index``: the mesh rank's coordinate on ``axis``."""
    return mesh.coords(rank)[axis]


# ---- collectives over one axis (lists of per-rank tensors) ---------------

def _sum_on(xs: Sequence[torch.Tensor], device: torch.device
            ) -> torch.Tensor:
    """The sum of ``xs`` in rank order, formed on ``device``."""
    total = xs[0].to(device)
    for x in xs[1:]:
        total = total + x.to(device)
    return total


def reduce_mean(xs: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The rank-order sum of per-rank tensors divided by their count,
    formed on ``device`` (the psum / n of a mean-reduction, kept on one
    rank; one IEEE division on any device)."""
    total = _sum_on(xs, device)
    return total / total.new_full((), float(len(xs)))


class _PSum(torch.autograd.Function):
    """All-reduce: every rank gets the rank-order sum on its own device.
    The backward is the same all-reduce of the ranks' gradients."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        return tuple(_sum_on(xs, d) for d in ctx.devices)

    @staticmethod
    def backward(ctx, *gs):
        return tuple(_sum_on(gs, d) for d in ctx.devices)


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.psum`` over one axis: each rank's tensor becomes the sum of
    all ranks' tensors (in rank order, on that rank's device)."""
    if len(xs) == 1:
        return list(xs)
    return list(_PSum.apply(*xs))


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0
               ) -> List[torch.Tensor]:
    """``lax.all_gather(..., axis=dim, tiled=True)`` over one axis: every
    rank gets the ranks' tensors joined along ``dim``, on its device."""
    return [torch.cat([x.to(x_r.device) for x in xs], dim) for x_r in xs]


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """``lax.all_to_all``: rank ``r`` receives piece ``r`` of every
    rank's tensor split along ``split_dim`` into as many pieces as there
    are ranks, joined along ``concat_dim`` in rank order.  (With a
    leading dim of size n split and joined on 0 this is JAX's
    ``tiled=False`` exchange of ``[n, ...]`` arrays.)"""
    n = len(xs)
    pieces = [x.chunk(n, split_dim) for x in xs]
    devs = [x.device for x in xs]
    return [torch.cat([p[r].to(devs[r]) for p in pieces], concat_dim)
            for r in range(n)]


def ppermute(xs: Sequence[Optional[torch.Tensor]],
             perm: Sequence[Tuple[int, int]],
             devices: Optional[Sequence[torch.device]] = None
             ) -> List[Optional[torch.Tensor]]:
    """``lax.ppermute``: for each ``(src, dst)`` in ``perm``, rank
    ``dst`` receives rank ``src``'s tensor on its device.  A rank that
    receives nothing gets ``None`` (JAX fills zeros), and so does one
    whose source holds ``None``.  ``devices`` (default: the tensors')
    names each rank's device."""
    devs = list(devices) if devices is not None else [x.device for x in xs]
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in perm:
        if xs[src] is not None:
            out[dst] = xs[src].to(devs[dst])
    return out


# ---- placing whole tensors over the mesh ---------------------------------

class NamedSharding:
    """A placement of whole tensors over ``mesh``: ``spec`` names, for
    each leading dim, the mesh axis that splits it into equal contiguous
    pieces (``None``: the dim is whole).  A rank holds the piece at its
    coordinates on the named axes; the axes the spec does not name hold
    replicas."""

    def __init__(self, mesh: Mesh, spec: Tuple[Optional[str], ...]):
        for axis in spec:
            if axis is not None and axis not in mesh.shape:
                raise ValueError(f"spec {spec} names {axis!r}, not an "
                                 f"axis of {mesh.shape}")
        self.mesh = mesh
        self.spec = tuple(spec)

    def _slices(self, shape, rank: int) -> Tuple[slice, ...]:
        coords = self.mesh.coords(rank)
        out = []
        for dim, size in enumerate(shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            if axis is None:
                out.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            if size % n:
                raise ValueError(f"dim {dim} of size {size} does not split "
                                 f"over {axis!r} of size {n}")
            w = size // n
            out.append(slice(coords[axis] * w, (coords[axis] + 1) * w))
        return tuple(out)

    def shard(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One shard per mesh rank, in rank order, each on its rank's
        device.  Differentiable: each shard's gradient flows back into
        its place in ``x``, summed over the ranks that hold it."""
        if self.mesh.size == 1:
            return [x.to(self.mesh.devices[0])]
        return list(_Place.apply(x, self))

    def join(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The transpose of :meth:`shard`: the whole tensor from one shard
        per mesh rank, on rank 0's device, each piece the rank-order sum
        of the replicas that hold it (a replicated shard's gradients
        summed).  Not differentiable."""
        dev = self.mesh.devices[0]
        shape = list(shards[0].shape)
        for dim, axis in enumerate(self.spec[:len(shape)]):
            if axis is not None:
                shape[dim] *= self.mesh.shape[axis]
        held: Dict[Tuple, List[torch.Tensor]] = {}
        for r, s in enumerate(shards):
            key = tuple((sl.start, sl.stop) for sl in self._slices(shape, r))
            held.setdefault(key, []).append(s)
        out = torch.empty(shape, dtype=shards[0].dtype, device=dev)
        for key, group in held.items():
            out[tuple(slice(a, b) for a, b in key)] = _sum_on(group, dev)
        return out


class _Place(torch.autograd.Function):
    """:meth:`NamedSharding.shard` with its transpose as the backward:
    the gradients of a piece's replicas summed in rank order."""

    @staticmethod
    def forward(ctx, x, sharding):
        ctx.sharding, ctx.device = sharding, x.device
        return tuple(x[sharding._slices(x.shape, r)].to(d)
                     for r, d in enumerate(sharding.mesh.devices))

    @staticmethod
    def backward(ctx, *gs):
        return ctx.sharding.join(gs).to(ctx.device), None


def named_sharding(mesh: Mesh, *spec: Optional[str]) -> NamedSharding:
    """The counterpart of ``NamedSharding(mesh, PartitionSpec(*spec))``."""
    return NamedSharding(mesh, spec)
