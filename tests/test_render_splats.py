"""render = projection + render_splats, on one device and on a mesh.

Given the same projected splats, the sharded path (exchange, strip
binning, rasterize) must reproduce the single-device frame bit for bit;
chip_smoke.py makes the same check on four GPUs, where the two paths'
projections are different XLA programs.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu.parallel import distributed, mesh as meshlib
from gaussian_splat_ipu_tpu.render.pipeline import render, render_splats
from gaussian_splat_ipu_tpu.render.projection import project_gaussians
from gaussian_splat_ipu_tpu.utils.config import RasterConfig

CFG = RasterConfig(image_width=96, image_height=64, pair_capacity=1 << 12,
                   max_chunks_per_tile=8)


def _scene(n=300):
    model = GaussianModel.random(jax.random.PRNGKey(5), n, extent=1.0)
    cam = Camera.orbit(np.full(3, -1.0, np.float32),
                       np.full(3, 1.0, np.float32),
                       fov_radians=np.radians(40.0), aspect=96 / 64)
    return model, cam


def test_render_is_projection_then_render_splats():
    model, cam = _scene()
    whole = render(model, cam, CFG)
    parts = render_splats(project_gaussians(model, cam, CFG), CFG)
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("g,exact", [(1, False), (2, True)])
def test_sharded_splats_bit_identical(g, exact):
    cfg = dataclasses.replace(CFG, tile_group=g, exact_tile_test=exact)
    model, cam = _scene()
    splats = project_gaussians(model, cam, cfg)
    ref = render_splats(splats, cfg)
    mesh = meshlib.make_mesh(4)
    on_mesh = NamedSharding(mesh, P(meshlib.SHARD_AXIS))
    out = distributed.render_splats_sharded(
        jax.device_put(splats, on_mesh), cfg, mesh,
        pair_capacity=cfg.pair_capacity)
    assert int(out.overflow) == int(out.exchange_overflow) == 0
    assert int(out.num_pairs) == int(ref.num_pairs) > 0
    np.testing.assert_array_equal(np.asarray(out.image),
                                  np.asarray(ref.image))
