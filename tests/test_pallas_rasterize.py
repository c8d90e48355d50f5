"""Rasterize kernels vs the jnp spec and the dense oracle.

Runs the kernels in the Pallas interpreter on the CPU; the same kernels
compile for the GPU (chip_smoke.py checks them there).
"""

import numpy as np
import jax
import jax.numpy as jnp

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu.ops import transforms
from gaussian_splat_ipu_tpu.render.oracle import render_oracle
from gaussian_splat_ipu_tpu.render.pipeline import render, render_image
from gaussian_splat_ipu_tpu.utils.config import RasterConfig

import pytest

CFG = RasterConfig(image_width=128, image_height=96, tile_width=32,
                   tile_height=32, chunk_size=32, pair_capacity=8192,
                   max_chunks_per_tile=16)


def camera(w=128, h=96):
    view = transforms.look_at([0.0, 0.5, 4.0], [0.0, 0.0, 0.0],
                              [0.0, 1.0, 0.0])
    proj = transforms.perspective(np.radians(50.0), w / h, 0.1, 100.0)
    return Camera(view, proj)


@pytest.mark.slow
def test_pallas_matches_oracle():
    model = GaussianModel.random(jax.random.PRNGKey(0), 200)
    cam = camera()
    ref = np.asarray(render_oracle(model, cam, CFG))
    got = np.asarray(render(model, cam, CFG, use_pallas=True).image)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)


def test_pallas_smoke_fast_tier():
    """Fast-tier Pallas coverage (the rest of this file is `slow`): a
    minimal scene through the real kernel path (interpret mode on CPU)
    against the jnp spec, sized so the whole test stays in single-digit
    seconds on a loaded box."""
    cfg = RasterConfig(image_width=32, image_height=32, tile_width=32,
                       tile_height=32, chunk_size=16, pair_capacity=512,
                       max_chunks_per_tile=4)
    model = GaussianModel.random(jax.random.PRNGKey(5), 24)
    cam = camera(32, 32)
    a = np.asarray(render(model, cam, cfg, use_pallas=False).image)
    b = np.asarray(render(model, cam, cfg, use_pallas=True).image)
    np.testing.assert_allclose(b, a, atol=1e-5)
    assert a[..., 3].max() > 0.0  # something actually rendered


@pytest.mark.slow
def test_pallas_matches_jnp_exactly():
    # The kernel and the jnp spec share chunk math; agreement should be
    # near bit-exact (both f32, same op order up to matmul-vs-cumsum).
    model = GaussianModel.random(jax.random.PRNGKey(1), 300)
    cam = camera()
    a = np.asarray(render(model, cam, CFG, use_pallas=True).image)
    b = np.asarray(render(model, cam, CFG, use_pallas=False).image)
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.slow
def test_pallas_empty_scene():
    cfg = RasterConfig(image_width=64, image_height=32, tile_width=32,
                       tile_height=32, chunk_size=8, pair_capacity=64,
                       background=(0.1, 0.2, 0.3))
    model = GaussianModel.random(jax.random.PRNGKey(2), 4)
    # Put them all behind the camera -> zero visible pairs.
    model = GaussianModel(model.means + jnp.array([0.0, 0.0, 100.0]),
                          model.log_scales, model.quats, model.opacities,
                          model.sh)
    img = np.asarray(render(model, camera(64, 32), cfg,
                            use_pallas=True).image)
    np.testing.assert_allclose(img[..., :3],
                               np.broadcast_to([0.1, 0.2, 0.3],
                                               img[..., :3].shape),
                               atol=1e-6)
    np.testing.assert_allclose(img[..., 3], 0.0, atol=1e-6)


@pytest.mark.slow
def test_pallas_gradients_match_jnp_path():
    model = GaussianModel.random(jax.random.PRNGKey(3), 64)
    cam = camera()
    cfg = RasterConfig(image_width=64, image_height=64, tile_width=32,
                       tile_height=32, chunk_size=16, pair_capacity=2048,
                       max_chunks_per_tile=8)
    target = jnp.zeros((64, 64, 4))

    def loss(m, use_pallas):
        img = render_image(m, cam, cfg, use_pallas)
        return jnp.mean((img - target) ** 2)

    g_pallas = jax.grad(lambda m: loss(m, True))(model)
    g_jnp = jax.grad(lambda m: loss(m, False))(model)
    for a, b in zip(jax.tree.leaves(g_pallas), jax.tree.leaves(g_jnp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6,
                                   rtol=1e-4)
    assert float(jnp.abs(g_pallas.means).sum()) > 0
