"""Meshes of the port (reference: ``src/repro/launch/mesh.py``).

A mesh is named axes over ranks: ``("data", "model")`` with sizes
``(data, model)`` over ``data · model`` ranks of one ``torch.distributed``
process group, rank r at ``(r // model, r % model)`` (row-major, as
``jax.make_mesh`` lays devices out).  Each axis has its own process
subgroups: the ranks that differ only in that axis' coordinate.  The
collectives of ``parallel/ctx.py`` run over them.

``make_host_mesh()`` is the (1, 1) mesh of one process, with no process
group: every collective over it is the identity.  ``make_mesh(data,
model)`` needs ``torch.distributed`` initialised with a world of ``data ·
model`` ranks (``parallel/launch.py:spawn`` does that); every rank must
call it, in the same order, since each subgroup is made collectively.
Several meshes may be made over one world (one spawn runs a (1, 4), a
(2, 2) and a (4, 1) mesh in turn).

The card's rates live in ``launch/roofline.py``; the reference's TPU v5e
constants are not carried over.  The reference's ``make_production_mesh``
(256 or 512 chips) has no counterpart here: the sharding rules take any
sizes (``parallel/sharding.py``), and the port runs on one to four cards.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch.distributed as dist

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """Axis sizes (``shape``: {name: size}, in ``axis_names`` order), this
    process's rank in the world, and each axis' subgroup holding it
    (empty for a one-process mesh)."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...] = AXES
    rank: int = 0
    groups: Dict[str, object] = field(default_factory=dict, compare=False)

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """{axis: coordinate} of ``rank`` (default this process's):
        row-major over ``axis_names``."""
        r = self.rank if rank is None else rank
        out = {}
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.axis_names}


def make_host_mesh() -> Mesh:
    """The (1, 1) mesh of this one process (tests, examples)."""
    return Mesh({"data": 1, "model": 1})


def make_mesh(data: int, model: int) -> Mesh:
    """A (data, model) mesh over the initialised world, with one subgroup
    per axis coordinate line (made collectively: every rank calls this)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(parallel.launch.spawn); make_host_mesh() is "
                           "the one-process mesh")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the world has {world}")
    mesh = Mesh({"data": data, "model": model}, rank=dist.get_rank())
    groups = {}
    # every rank makes every subgroup, in one order
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        g = dist.new_group(ranks)
        if mesh.rank in ranks:
            groups["model"] = g
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        g = dist.new_group(ranks)
        if mesh.rank in ranks:
            groups["data"] = g
    return Mesh(mesh.shape, mesh.axis_names, mesh.rank, groups)
