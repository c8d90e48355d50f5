"""Device mesh construction + parameter sharding helpers.

The reference's only multi-device notion is `RuntimeConfig.numIpus` /
`numReplicas` plumbed into a Poplar virtual graph over 1440 tiles of ONE IPU
(reference: include/ipu/ipu_utils.hpp:174-183,554-555 — replication exists
but is always 1). Here multi-device is first-class: a 1D `jax.sharding.Mesh`
whose single axis simultaneously shards gaussians (data parallelism over
primitives) and framebuffer tile rows (spatial parallelism) — the two axes
the reference maps onto IPU tiles (SURVEY.md §2 parallelism table).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# The model-parallel mesh axis: shards gaussians at projection time and
# framebuffer tile rows at rasterization time (same devices, two roles).
SHARD_AXIS = "shard"
# The data-parallel mesh axis: shards a batch of camera views (training).
VIEW_AXIS = "view"


def make_mesh(num_devices: int | None = None,
              axis: str = SHARD_AXIS) -> Mesh:
    devices = jax.devices()
    n = len(devices) if num_devices is None else num_devices
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n]), (axis,))


def make_mesh_2d(num_views: int, num_shards: int | None = None,
                 view_axis: str = VIEW_AXIS,
                 shard_axis: str = SHARD_AXIS) -> Mesh:
    """(view, shard) mesh: data parallelism over camera views on the outer
    axis, gaussian/tile-row sharding on the inner (the shard axis carries
    the per-frame exchange; the view axis only moves gradients once). The
    device list is flat: on NVLink every card reaches every other at the
    same rate, so the layout follows the algorithm alone."""
    devices = jax.devices()
    if num_shards is None:
        num_shards = len(devices) // num_views
    n = num_views * num_shards
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    grid = np.asarray(devices[:n]).reshape(num_views, num_shards)
    return Mesh(grid, (view_axis, shard_axis))


def gaussian_sharding(mesh: Mesh, axis: str = SHARD_AXIS) -> NamedSharding:
    """Leading (gaussian) dimension sharded, everything else replicated."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_model(model, mesh: Mesh, axis: str = SHARD_AXIS):
    """Place a GaussianModel with the N axis sharded across the mesh.

    Pads N up to a multiple of the mesh size (padding gaussians have
    opacity -inf and render as nothing — models/gaussians.py pad_to).

    Works in multi-process runs too: when the mesh spans devices this
    process cannot address (jax.distributed), each process feeds only its
    local shards via make_array_from_callback — every process must hold
    the same host-replicated model (same file / same PRNG seed), the
    usual multi-controller SPMD contract.
    """
    d = mesh.shape[axis]
    n = model.num_gaussians
    n_pad = -(-n // d) * d
    if n_pad != n:
        model = model.pad_to(n_pad)
    sharding = gaussian_sharding(mesh, axis)
    local = {dev.id for dev in jax.local_devices()}
    if all(dev.id in local for dev in mesh.devices.flat):
        return jax.device_put(model, sharding)

    def to_global(x):
        host = np.asarray(x)
        spec = P(*([axis] + [None] * (x.ndim - 1)))
        return jax.make_array_from_callback(
            host.shape, NamedSharding(mesh, spec),
            lambda idx: host[idx])

    return jax.tree.map(to_global, model)
