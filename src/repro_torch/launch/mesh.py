"""Device meshes (port of ``repro/launch/mesh.py``) on
``torch.distributed.device_mesh``.

Functions, not module constants, so that importing never touches the
process group. Single pod: 16 x 16 = 256 ranks (data, model). Multi-pod:
2 x 16 x 16 = 512 ranks with a leading 'pod' axis (pure DP across pods).
Each needs the default process group up (``torchrun`` or
``init_process_group``) with a world of exactly that size. The mesh dims
are ordered pod, data, model, so a spec entry ``("pod", "data")`` shards
pod-major, as JAX's does.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _size(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


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
