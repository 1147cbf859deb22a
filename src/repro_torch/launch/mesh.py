"""Mesh construction (the counterpart of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module starts no
process and touches no device.  Each builds a :class:`Mesh` over the
current process group (``torchrun``, or ``repro_torch.distributed.spawn``)
and raises if its size is not the world's.
"""

from __future__ import annotations

from ..distributed.collectives import Mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16×16 = 256 ranks (one pod), or 2×16×16 = 512 over two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.over_world(shape, axes, device)


def make_debug_mesh(shape=(2, 4), axes=("data", "model"),
                    device=None) -> Mesh:
    """A small mesh: 8 ranks by default (``torchrun --nproc-per-node 8``,
    or 8 spawned CPU ranks in the tests)."""
    return Mesh.over_world(shape, axes, device)
