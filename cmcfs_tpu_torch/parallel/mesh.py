"""The X split of the 3D solver over devices (port of
cmcfs_tpu/parallel/mesh.py).

The reference's multi-GPU tier is one process over several cards: GPUplan
splits X over the cards (GPUplan.cpp:122-155), each shard's arrays keep one
halo plane at both ends (TimeLayer3D.h:345-356), ``syncHalos`` fills them
with peer copies (TimeLayer3D.h:272-335), and MGPU_EMU fakes 16 GPUs on
device 0 (GPUplan.h:10-15).  ``ShardingPlan`` is that tier in PyTorch: one
X slab of every field on each device of its list, each slab one plane
longer at both ends than the planes it owns, the halo planes filled from
the neighbours by plane copies (``exchange``).  The X sweep, whose lines
cross the shards, reshards the fields so that Y splits instead
(``reshard``: the all_to_all of cmcfs_tpu's mesh, adi3d.py:604-680).

The shards need not own equal runs of planes: the port cuts X where
cmcfs_tpu's padding to a multiple of the shard count puts the even cuts
(``models/solver3d.AdiSolver3D.set_plan``) without storing the padding
planes, and Y into near-equal runs.

An explicit device list runs N shards on any devices: ``["cuda:0"] * 4``
is the MGPU_EMU analogue on one card, ``["cpu"] * 4`` the counterpart of
cmcfs_tpu's virtual CPU mesh (tests/conftest.py).  Every copy goes onto
its destination with ``non_blocking=True``; the step synchronizes each
device once at its end (``synchronize``).

``nblockz`` > 1 (the reference's ``blocking nBlockZ``) sends the X
sweep's fallback through the Z-blocked wavefront (``parallel/pipeline.py``)
instead of the reshard, as cmcfs_tpu's plan does (mesh.py:33-51).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def even_cuts(extent: int, n: int) -> list:
    """``extent`` planes cut into ``n`` runs, the first ``extent % n`` one
    plane longer."""
    return [extent // n + (i < extent % n) for i in range(n)]


class ShardingPlan:
    """N shards over ``devices`` (one entry a shard; entries may repeat).

    A shard's slab along a split dimension holds the planes it owns (a
    run of consecutive planes, ``cuts[i]`` of them) and one halo plane at
    each end: index 0 and cuts[i] + 1.  The halos are the neighbours'
    nearest planes, the first and the last shard each other's: the
    periodic wrap of ``torch.roll``, which the single device's stencils
    apply at the grid's ends, so that a step over the shards reads what
    the single device's step reads."""

    def __init__(self, devices: Sequence, nblockz: int = 0):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a plan needs at least one device")
        self.nblockz = nblockz

    @property
    def n(self) -> int:
        return len(self.devices)

    def split(self, a, dim: int, cuts: Sequence[int]) -> list:
        """The slabs of ``a`` (a tensor, or anything ``torch.as_tensor``
        takes) along ``dim``, ``cuts[i]`` planes owned by shard i, each
        slab on its shard's device with both halos filled."""
        a = torch.as_tensor(a)
        if sum(cuts) != a.shape[dim] or min(cuts) < 1:
            raise ValueError(f"cuts {list(cuts)} do not split "
                             f"{a.shape[dim]} planes")
        out, start = [], 0
        for c, dev in zip(cuts, self.devices):
            idx = torch.arange(start - 1, start + c + 1,
                               device=a.device) % a.shape[dim]
            out.append(a.index_select(dim, idx).to(dev))
            start += c
        return out

    def gather(self, slabs: list, dim: int) -> torch.Tensor:
        """The planes the slabs own along ``dim``, in order, on the first
        shard's device."""
        return torch.cat([t.narrow(dim, 1, t.shape[dim] - 2).to(
            self.devices[0]) for t in slabs], dim=dim)

    def exchange(self, slabs: list, dim: int) -> None:
        """Fill every slab's two halo planes along ``dim`` in place from
        its neighbours' nearest owned planes (two plane copies a pair of
        neighbours, periodic)."""
        for i, a in enumerate(slabs):
            b = slabs[(i + 1) % len(slabs)]
            b.narrow(dim, 0, 1).copy_(a.narrow(dim, a.shape[dim] - 2, 1),
                                      non_blocking=True)
            a.narrow(dim, a.shape[dim] - 1, 1).copy_(b.narrow(dim, 1, 1),
                                                     non_blocking=True)

    def reshard(self, slabs: list, src: int, dst: int,
                cuts: Sequence[int]) -> list:
        """Slabs split along ``src`` (whole along ``dst``) as slabs split
        along ``dst`` into ``cuts`` (whole along ``src``): the all_to_all,
        each block copied from the shard that owns it.  The new slabs'
        halos are not filled: ``exchange`` fills them."""
        src_cuts = [t.shape[src] - 2 for t in slabs]
        out, b0 = [], 0
        for c, dev in zip(cuts, self.devices):
            shape = list(slabs[0].shape)
            shape[src], shape[dst] = sum(src_cuts), c + 2
            t = torch.empty(shape, dtype=slabs[0].dtype, device=dev)
            a0 = 0
            for slab, ca in zip(slabs, src_cuts):
                t.narrow(src, a0, ca).narrow(dst, 1, c).copy_(
                    slab.narrow(src, 1, ca).narrow(dst, b0, c),
                    non_blocking=True)
                a0 += ca
            out.append(t)
            b0 += c
        return out

    def all_max(self, vals: list) -> list:
        """The max of one 0-d tensor a shard, reduced on the first shard's
        device and copied back to each shard's device (the Poisson loop's
        stop test: a max is the same in any order)."""
        dev = self.devices[0]
        m = torch.stack([v.to(dev, non_blocking=True) for v in vals]).amax()
        return [m.to(d, non_blocking=True) for d in self.devices]

    def synchronize(self) -> None:
        """Wait for every CUDA device of the plan (once each)."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def make_x_mesh(n_devices: Optional[int] = None, devices=None,
                device: str = "cuda") -> ShardingPlan:
    """A plan over ``devices`` as given (an explicit list: its order is
    the shards' order, and an entry may repeat), else over the first
    ``n_devices`` CUDA devices (all visible ones by default), else, with
    ``device="cpu"``, over ``n_devices`` CPU shards.  Without a list it
    raises when fewer cards are visible than asked for (cmcfs_tpu
    mesh.py:127-135; the reference errors likewise, GPUplan.cpp:35-50):
    it never runs on fewer cards, or on the CPU, by itself."""
    if devices is not None:
        devs = list(devices)
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"requested {n_devices} shards of a "
                                 f"{len(devs)}-device list")
            devs = devs[:n_devices]
        return ShardingPlan(devs)
    if torch.device(device).type == "cpu":
        return ShardingPlan(["cpu"] * (1 if n_devices is None
                                       else n_devices))
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else n_devices
    if n < 1 or n > visible:
        raise ValueError(
            f"requested a {n}-device mesh but only {visible} CUDA "
            f"device(s) are visible (the reference errors likewise when "
            f"GPU n exceeds the machine, GPUplan.cpp:35-50)")
    return ShardingPlan([f"cuda:{i}" for i in range(n)])
