"""Device meshes over ``torch.distributed`` and the row blocks of the SNARK layouts.

Port of ``ringsnark_tpu/parallel/mesh.py``.  The JAX package is one
controller over ``jax.devices()`` (``Mesh`` + ``NamedSharding``, GSPMD
inserts the collectives); here every device is a process of one
``torch.distributed`` world (one rank per GPU, NCCL; gloo ranks on the CPU
when a caller asks for them), the mesh is a named ``DeviceMesh`` over that
world, and every reshard is an explicit collective.

A sharding is a description: which leading axis of a tensor is split over
which mesh dimension.  ``Sharding.local(x)`` is this rank's block (the
counterpart of ``jax.device_put(x, NamedSharding)``).  Blocks are row
ranges, uneven where the size does not divide (``np.array_split``'s), so
nothing is padded: a missing row and a zero-padded one add the same exact
zero to an inner product.
"""

from __future__ import annotations

import datetime
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = [
    "make_mesh",
    "init_single_process",
    "init_rank",
    "Sharding",
    "crs_sharding",
    "ring_sharding",
    "replicate",
    "axis_size",
    "axis_rank",
    "axis_group",
    "block",
    "BACKENDS",
    "TIMEOUT_S",
]

# the process-group backend of each device type: nothing picks another
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# a collective that waits longer than this fails its call (gloo's own
# default is 30 minutes)
TIMEOUT_S = 60


def init_rank(rank: int, world_size: int, init_file: str | Path,
              device_type: str = "cuda") -> None:
    """Join a world of `world_size` ranks through a file store (no port to
    pick): NCCL for ``"cuda"`` (rank r on GPU r), gloo for ``"cpu"``.  A
    failed init raises."""
    if device_type not in BACKENDS:
        raise ValueError(f"device type {device_type!r} is not one of {tuple(BACKENDS)}")
    if device_type == "cuda":
        if torch.cuda.device_count() <= rank:
            raise RuntimeError(f"rank {rank} needs GPU {rank}; "
                               f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(rank)
    dist.init_process_group(BACKENDS[device_type], init_method=f"file://{init_file}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def init_single_process(device_type: str = "cuda") -> None:
    """A world of one rank (file store under a new temporary directory): the
    mesh of one card, or of the CPU when ``device_type="cpu"``."""
    init_rank(0, 1, Path(tempfile.mkdtemp(prefix="ringsnark_pg_")) / "pg", device_type)


def make_mesh(n_devices: int | None = None, limb: int = 1, coeff: int = 1,
              device_type: str | None = None) -> DeviceMesh:
    """('limb', 'data') mesh over the world, or ('limb', 'coeff', 'data')
    when coeff > 1.

    limb * coeff must divide n_devices; 'data' gets the rest.  The mesh
    covers the whole world (n_devices defaults to, and must equal, its
    size).  'coeff' carries the witness map's NTT coefficient sharding
    (parallel/witness_sharded.py), 'data' the CRS batch, 'limb' the
    independent outer RNS channels.  `device_type` defaults to "cuda"; the
    process group's backend must be that device type's (NCCL for "cuda",
    gloo for "cpu")."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: call init_rank "
                           "in every rank (or init_single_process) first")
    device_type = device_type or "cuda"
    want = BACKENDS.get(device_type)
    if want is None or dist.get_backend() != want:
        raise RuntimeError(f"a {device_type!r} mesh needs the {want} backend, the process "
                           f"group has {dist.get_backend()}")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    assert n == world, f"the mesh covers the world: {n} devices asked, world size {world}"
    assert n % (limb * coeff) == 0, (n, limb, coeff)
    if coeff > 1:
        return init_device_mesh(device_type, (limb, coeff, n // (limb * coeff)),
                                mesh_dim_names=("limb", "coeff", "data"))
    return init_device_mesh(device_type, (limb, n // limb), mesh_dim_names=("limb", "data"))


def _dim(mesh: DeviceMesh, name: str) -> int:
    return mesh.mesh_dim_names.index(name)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.mesh.shape[_dim(mesh, name)]


def axis_rank(mesh: DeviceMesh, name: str) -> int:
    """This rank's index along the mesh dimension `name`."""
    return mesh.get_local_rank(_dim(mesh, name))


def axis_group(mesh: DeviceMesh, name: str):
    return mesh.get_group(_dim(mesh, name))


def block(n: int, parts: int, idx: int) -> slice:
    """Rows of block idx of n rows in `parts` blocks (the first n % parts one
    row longer)."""
    base, extra = divmod(n, parts)
    lo = idx * base + min(idx, extra)
    return slice(lo, lo + base + (idx < extra))


@dataclass(frozen=True)
class Sharding:
    """`spec[i]` names the mesh dimension axis i of a tensor is split over
    (None: whole); axes past the spec are whole."""

    mesh: DeviceMesh
    spec: tuple

    def slices(self, shape) -> tuple:
        """This rank's block of a tensor of `shape`, one slice per spec axis."""
        return tuple(
            slice(None) if name is None
            else block(shape[i], axis_size(self.mesh, name), axis_rank(self.mesh, name))
            for i, name in enumerate(self.spec))

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of x (a view)."""
        return x[self.slices(x.shape)]


def crs_sharding(mesh: DeviceMesh) -> Sharding:
    """Ciphertext batch [B, L, L', N']: B over data, outer limbs over limb."""
    return Sharding(mesh, ("data", "limb"))


def ring_sharding(mesh: DeviceMesh, batched: bool = True) -> Sharding:
    """Ring batch [B, L, n]: B over data, L over limb (unbatched [L, n]:
    L over limb)."""
    return Sharding(mesh, ("data", "limb") if batched else ("limb",))


def replicate(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, ())
