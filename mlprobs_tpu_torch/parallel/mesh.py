"""The pairs mesh: the devices that share one family's pair batches.

The counterpart of the JAX package's `parallel/mesh.py`.  The MLProbs
workload has one natural parallel axis, the N(N-1)/2 sequence pairs of
the posterior and consistency stages.  As in the JAX package, one
process drives every device of the mesh: a batch of pairs is split along
its pair axis, each device runs its share, and the outputs are gathered
on the caller's device (`split_pairs`, `gather`).  A pair's work needs
nothing from another pair, so the posterior stage runs no collective;
the consistency rounds copy every row block of the pair matrix to every
device (parallel/sharded.py).

A mesh may name one device more than once.  The CPU tests run a mesh of
eight "cpu" entries, as the JAX package's tests run eight virtual CPU
devices, and a machine with one card can run the sharded routes on a
mesh of "cuda:0" twice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch


@dataclass(frozen=True)
class PairsMesh:
    """An ordered tuple of devices along the one mesh axis, `pairs`."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _indexed(dev) -> torch.device:
    """`dev` as a torch.device; a card named without its index gets the
    current one, so that a mesh device compares equal to a tensor's."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pairs_mesh(devices: Sequence | None = None) -> PairsMesh:
    """The mesh of `devices`, a sequence of devices (or their names) in
    mesh order, or of every visible card when it is None."""
    if devices is None:
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devs = tuple(_indexed(d) for d in devices)
    if not devs:
        raise ValueError("a pairs mesh needs at least one device")
    return PairsMesh(devs)


def split_pairs(tensors: Sequence[torch.Tensor], mesh: PairsMesh) -> list:
    """Each device's share of the leading (pair) axis of every tensor, on
    that device: [(device, shards)] in mesh order, without the devices
    whose share is empty (a batch smaller than the mesh)."""
    parts = [t.tensor_split(mesh.size) for t in tensors]
    out = []
    for k, dev in enumerate(mesh.devices):
        shard = [p[k] for p in parts]
        if shard[0].shape[0]:
            out.append((dev, [s.to(dev) for s in shard]))
    return out


def gather(outputs: Sequence[Sequence[torch.Tensor]],
           axes: Sequence[int], device) -> tuple:
    """Concatenate the devices' outputs on `device`: output k along its
    pair axis `axes[k]` (0 for per-pair values, 1 for (D, B, ...)
    planes)."""
    return tuple(
        torch.cat([out[k].to(device) for out in outputs], dim=ax)
        for k, ax in enumerate(axes)
    )
