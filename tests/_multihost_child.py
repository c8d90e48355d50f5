"""Child process for the 2-process multi-host test (test_multihost.py).

Each process contributes 4 virtual CPU devices to an 8-device global mesh
via jax.distributed + gloo CPU collectives, renders a deterministic scene
with the SAME shard_map code used across GPU hosts, and prints the replicated
image mean. Usage: python _multihost_child.py <pid> <nproc> <coordinator>.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
except Exception:  # older jax: option absent
    pass

pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

from gaussian_splat_ipu_tpu.parallel import multihost  # noqa: E402

try:
    ok = multihost.initialize(coord, nproc, pid)
except Exception as e:  # pragma: no cover - environment dependent
    print(f"SKIP init failed: {e}", flush=True)
    sys.exit(0)
assert ok

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

if len(jax.devices()) != 8:
    print(f"SKIP expected 8 global devices, got {len(jax.devices())}",
          flush=True)
    sys.exit(0)

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa
from gaussian_splat_ipu_tpu.models.camera import Camera  # noqa: E402
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel  # noqa
from gaussian_splat_ipu_tpu.parallel import distributed  # noqa: E402
from gaussian_splat_ipu_tpu.utils.config import RasterConfig  # noqa: E402

CFG = RasterConfig(image_width=64, image_height=256,
                   pair_capacity=1 << 12, max_chunks_per_tile=4)

mesh = Mesh(np.asarray(jax.devices()), ("shard",))
host_model = GaussianModel.random(jax.random.PRNGKey(0), 128)
cam = Camera.orbit(np.array([-1.0, -1.0, -1.0], np.float32),
                   np.array([1.0, 1.0, 1.0], np.float32),
                   fov_radians=np.radians(45.0), aspect=0.25)


def to_global(x):
    sh = NamedSharding(mesh, P(*(["shard"] + [None] * (x.ndim - 1))))
    host = np.asarray(x)
    return jax.make_array_from_callback(host.shape, sh,
                                        lambda idx: host[idx])


model = jax.tree.map(to_global, host_model)


@jax.jit
def mean_of_render(m):
    img = distributed.render_image_sharded(m, cam, CFG, mesh,
                                           use_pallas=False,
                                           pair_capacity=1 << 12)
    return jnp.mean(img)


@jax.jit
def grad_norm(m):
    # Backward crosses processes through the all_gather's reduce-scatter
    # transpose; the summed norm is replicated.
    def loss(mm):
        img = distributed.render_image_sharded(mm, cam, CFG, mesh,
                                               use_pallas=False,
                                               pair_capacity=1 << 12)
        return jnp.mean(jnp.abs(img))

    g = jax.grad(loss)(m)
    return sum(jnp.sum(x * x) for x in jax.tree.leaves(g))


val = float(mean_of_render(model))
gn = float(grad_norm(model))
print(f"MEAN {val:.9f} GRADSQ {gn:.9f}", flush=True)
jax.distributed.shutdown()
