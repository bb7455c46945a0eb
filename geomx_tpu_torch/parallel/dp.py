"""Party-level data parallelism: one party = one mesh — the port of the
JAX package's ``parallel/dp.py``.

The reference's intra-DC tier (workers pushing to a local server over
the LAN) becomes one data-parallel step over the party's mesh: the
batch split over the ``dp`` ranks, the parameters replicated, and the
gradients mean-reduced across the ranks, so the host edge pushes ONE
already-aggregated gradient per tensor into the HiPS tier
(``workers_per_party=1``: the mesh is the worker).

The JAX package lowers that to one jitted GSPMD step; the port runs it
single-controller: each rank's shard of the batch goes through
``grad_fn`` on that rank's device, against that rank's own replica of
the parameters, and loss, accuracy and every gradient are reduced by an
explicit psum divided by the rank count.  A replica is a detached tensor
of its own per rank, so ranks that share a card never share an autograd
leaf (which would sum their gradients in place of the reduction).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from geomx_tpu_torch.parallel.mesh import Mesh, reduce_mean, visible_cards


def _split(a, n: int) -> list:
    """The batch's contiguous shards, one a rank (``P("dp")``)."""
    if len(a) % n:
        raise ValueError(f"batch of {len(a)} does not split over {n} ranks")
    w = len(a) // n
    return [a[r * w:(r + 1) * w] for r in range(n)]


def _per_rank(grad_fn: Callable, mesh: Mesh, params, x, y):
    """Run ``grad_fn`` on each rank of the mesh's first axis: its batch
    shard on its device, against its own detached replica of
    ``params``.  Returns ``([(loss, acc, grads)] by rank, devices)``."""
    devs = mesh.axis_devices(mesh.axis_names[0])
    n = len(devs)
    outs = []
    for dev, xs, ys in zip(devs, _split(x, n), _split(y, n)):
        replica = {k: v.detach().to(dev) for k, v in params.items()}
        outs.append(grad_fn(replica, xs, ys))
    return outs, devs


def make_party_step(grad_fn: Callable, mesh: Mesh) -> Callable:
    """Wrap ``grad_fn(params, x, y) -> (loss, acc, grads)`` into a
    party-wide data-parallel step over ``mesh``'s first axis (``dp``).

    Returns ``step(params, x, y)``: ``x`` and ``y`` (host arrays or
    tensors) split into contiguous shards, one a rank; loss, accuracy
    and each gradient mean-reduced across the ranks (psum / dp), on rank
    0's device, the gradients keyed as ``grad_fn`` keys them."""

    def step(params: Dict[str, torch.Tensor], x, y):
        outs, devs = _per_rank(grad_fn, mesh, params, x, y)
        grads = {k: reduce_mean([o[2][k] for o in outs], devs[0])
                 for k in outs[0][2]}
        return (reduce_mean([o[0] for o in outs], devs[0]),
                reduce_mean([o[1] for o in outs], devs[0]), grads)

    return step


def party_meshes(num_parties: int, devices=None, axis: str = "dp"
                 ) -> List[Mesh]:
    """Split the devices into one mesh per party (an ``axis`` of
    ``len(devices) // num_parties`` ranks each) — the simulation analog
    of "each party is its own pod slice".  ``devices`` defaults to every
    visible CUDA card; ``[card] * 4`` or ``["cpu"] * 4`` put several
    ranks on one device."""
    devices = list(visible_cards() if devices is None else devices)
    per = len(devices) // num_parties
    if per < 1:
        raise AssertionError(
            f"{len(devices)} devices cannot host {num_parties} parties")
    if len(devices) % num_parties:
        raise ValueError(
            f"{len(devices)} devices do not divide into {num_parties} "
            f"parties — {len(devices) % num_parties} chips would be "
            "silently stranded; pass an explicit device subset")
    return [Mesh({axis: per}, devices[p * per:(p + 1) * per])
            for p in range(num_parties)]
