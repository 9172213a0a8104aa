"""Device meshes (port of ``repro/launch/mesh.py``) on
``torch.distributed.device_mesh``.

Functions, not module constants, so that importing never touches the
process group. Single pod: 16 x 16 = 256 ranks (data, model). Multi-pod:
2 x 16 x 16 = 512 ranks with a leading 'pod' axis (pure DP across pods).
Each needs the default process group up (``torchrun`` or
``init_process_group``) with a world of exactly that size. The mesh dims
are ordered pod, data, model, so a spec entry ``("pod", "data")`` shards
pod-major, as JAX's does.

:func:`make_local_mesh` is the other kind: the devices one process drives,
named as ``jax.sharding.Mesh`` names them, with no process group. The CNN
serving tier (``CNNServer(mesh=)``) keeps one controller over it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _size(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """Devices of this process as a named grid: ``devices`` an object array
    of ``torch.device``, one array axis per name in ``axis_names``. A
    device may appear at several coordinates (two replicas on one card)."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def along(self, axes) -> list:
        """The devices at every coordinate of ``axes`` (mesh axis names, in
        the mesh's order, major to minor), each other axis at its index 0:
        one device per shard of a dim split over ``axes``, in shard order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        missing = [a for a in axes if a not in self.axis_names]
        if missing:
            raise ValueError(f"mesh axes {missing} are not in the mesh {self.axis_names}")
        dims = [self.axis_names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {axes} must come in the mesh's order {self.axis_names}")
        index = tuple(slice(None) if j in dims else 0 for j in range(len(self.axis_names)))
        return list(self.devices[index].reshape(-1))


def make_local_mesh(shape, axes, devices=None) -> LocalMesh:
    """A :class:`LocalMesh` of ``shape`` named ``axes`` over ``devices`` (a
    flat list in row-major order; by default the first ``prod(shape)``
    CUDA devices, or the CPU at every coordinate on a machine without a
    card)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = _size(shape)
    if devices is None:
        if torch.cuda.is_available():
            if torch.cuda.device_count() < n:
                raise ValueError(f"a {'x'.join(map(str, shape))} local mesh needs {n} devices; "
                                 f"this process sees {torch.cuda.device_count()} CUDA devices: "
                                 "pass devices= to repeat one")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [torch.device("cpu")] * n
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} local mesh needs {n} devices, got "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return LocalMesh(grid.reshape(shape), axes)


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """``init_device_mesh(device_type, shape, mesh_dim_names=axes)`` over
    the default process group, whose world must hold ``prod(shape)``
    ranks."""
    shape, axes = tuple(shape), tuple(axes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != _size(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh {axes} needs {_size(shape)} "
                         f"ranks; the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh: 16 x 16 (data, model), or 2 x 16 x
    16 (pod, data, model) with ``multi_pod``. Another world size raises
    and names both sizes."""
    shape, axes = PRODUCTION[multi_pod]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != _size(shape):
        sizes = " or ".join(f"{_size(s)} ({'x'.join(map(str, s))})" for s, _ in PRODUCTION.values())
        raise ValueError(f"the production mesh needs a world of {sizes} ranks; this one has "
                         f"{world}")
    return make_mesh(shape, axes, device_type)


make_test_mesh = make_mesh  # the reference's name for a small mesh


def tp_degree(mesh: DeviceMesh) -> int:
    """The size of the mesh's 'model' axis."""
    return mesh.size(mesh.mesh_dim_names.index("model"))
