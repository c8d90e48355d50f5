"""Exact tile-ellipse coverage test (RasterConfig.exact_tile_test):
pixel-identical output (modulo fp re-association from chunk re-packing)
with strictly fewer (gaussian, tile) pairs, across all three sort paths,
plus mask/decode unit checks."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu.render import binning
from gaussian_splat_ipu_tpu.render.oracle import render_oracle
from gaussian_splat_ipu_tpu.render.pipeline import render
from gaussian_splat_ipu_tpu.utils.config import RasterConfig

import pytest

BASE = RasterConfig(image_width=256, image_height=192,
                    pair_capacity=1 << 16)


def _scene(seed=0, n=2500, scale_boost=0.0):
    m = GaussianModel.random(jax.random.PRNGKey(seed), n, extent=1.0)
    if scale_boost:
        m = GaussianModel(m.means, m.log_scales + scale_boost, m.quats,
                          m.opacities, m.sh)
    cam = Camera.look_at([0.0, 0.5, 4.0], [0.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0], np.radians(50.0), 4 / 3)
    return m, cam


@pytest.mark.slow
def test_identical_image_fewer_pairs_all_sort_paths():
    m, cam = _scene()
    for presort, fused in [(False, True), (True, True), (False, False)]:
        c0 = dataclasses.replace(BASE, presort_depth=presort,
                                 fused_sort_key=fused)
        c1 = dataclasses.replace(c0, exact_tile_test=True)
        o0 = render(m, cam, c0, use_pallas=False)
        o1 = render(m, cam, c1, use_pallas=False)
        assert int(o1.num_pairs) < int(o0.num_pairs)  # a real cut
        np.testing.assert_allclose(np.asarray(o1.image),
                                   np.asarray(o0.image), atol=2e-6)


@pytest.mark.slow
def test_exact_mode_with_tile_test_matches_oracle():
    # Depth-exact sort paths (the default fused key quantizes depth, so
    # near-coincident splats may legally swap vs the oracle's full sort).
    m, cam = _scene(seed=3)
    for kw in ({"fused_sort_key": False},
               {"fused_sort_key": True, "presort_depth": True}):
        cfg = dataclasses.replace(BASE, extent_sigma=0.0,
                                  exact_tile_test=True, **kw)
        a = np.asarray(render(m, cam, cfg, use_pallas=False).image)
        b = np.asarray(render_oracle(m, cam, cfg))
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.slow
def test_gradients_unchanged():
    m, cam = _scene(n=600)

    def loss(mm, cfg):
        img = render(mm, cam, cfg, use_pallas=False).image
        return jnp.sum(img[..., :3] * jnp.cos(jnp.arange(3.0)))

    g0 = jax.grad(loss)(m, BASE)
    g1 = jax.grad(loss)(m, dataclasses.replace(BASE,
                                               exact_tile_test=True))
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5, rtol=1e-4)


@pytest.mark.slow
def test_big_splats_cut_grows_and_stays_exact():
    m, cam = _scene(seed=1, n=800, scale_boost=1.2)
    c1 = dataclasses.replace(BASE, exact_tile_test=True)
    o0 = render(m, cam, BASE, use_pallas=False)
    o1 = render(m, cam, c1, use_pallas=False)
    assert int(o1.num_pairs) <= int(o0.num_pairs)
    np.testing.assert_allclose(np.asarray(o1.image), np.asarray(o0.image),
                               atol=2e-6)
    # The cut also shrinks per-tile work: no tile may gain pairs.
    gained = np.asarray(o1.tile_counts) > np.asarray(o0.tile_counts)
    assert not gained.any()


def test_pair_tile_decode_masked_matches_rect_subset():
    # A hand-built mask: rect 3x2 at (x0, y0) = (5, 7), keep bits
    # {0, 2, 4, 5} of the row-major 8-wide window.
    x0, y0, nx = 5, 7, 3
    keep = [0, 2, 4 + 8 * 0, 5]          # k = dy*8+dx
    keep = sorted(set(keep))
    mlo = jnp.int32(sum(1 << k for k in keep))
    geom = jnp.int32(x0 | (y0 << 12) | (nx << 24) | (1 << 30))
    n = len(keep)
    tx, ty = binning._pair_tile_decode(
        jnp.full((n,), geom), jnp.full((n,), mlo),
        jnp.zeros((n,), jnp.int32), jnp.arange(n, dtype=jnp.int32))
    got = sorted((int(a), int(b)) for a, b in zip(tx, ty))
    want = sorted((x0 + (k & 7), y0 + (k >> 3)) for k in keep)
    assert got == want
    # Unmasked decode: plain row-major rectangle walk.
    geom_u = jnp.int32(x0 | (y0 << 12) | (nx << 24))
    r = jnp.arange(6, dtype=jnp.int32)
    tx, ty = binning._pair_tile_decode(
        jnp.full((6,), geom_u), jnp.zeros((6,), jnp.int32),
        jnp.zeros((6,), jnp.int32), r)
    assert [int(v) for v in tx] == [5, 6, 7, 5, 6, 7]
    assert [int(v) for v in ty] == [7, 7, 7, 8, 8, 8]


def test_high_bit_mask_words():
    # rank selection must cross into the high word and handle bit 31.
    mlo = jnp.int32(np.int32(np.uint32(0x80000001)))  # bits 0 and 31
    mhi = jnp.int32(np.int32(np.uint32(0x80000000)))  # bit 63 -> tile (7,7)
    geom = jnp.int32(0 | (0 << 12) | (8 << 24) | (1 << 30))
    tx, ty = binning._pair_tile_decode(
        jnp.full((3,), geom), jnp.full((3,), mlo), jnp.full((3,), mhi),
        jnp.arange(3, dtype=jnp.int32))
    got = [(int(a), int(b)) for a, b in zip(tx, ty)]
    assert got == [(0, 0), (7, 3), (7, 7)]


@pytest.mark.slow
def test_distributed_render_with_tile_test():
    from gaussian_splat_ipu_tpu.parallel import distributed, mesh as meshlib

    m, cam = _scene(seed=5, n=256)
    cfg = dataclasses.replace(
        BASE, image_width=96, image_height=96, pair_capacity=1 << 13,
        max_chunks_per_tile=8, exact_tile_test=True)
    ref = render(m, cam, cfg, use_pallas=False)
    mesh = meshlib.make_mesh(8)
    sharded = meshlib.shard_model(m, mesh)
    out = distributed.render_sharded(sharded, cam, cfg, mesh,
                                     use_pallas=False,
                                     pair_capacity=1 << 13)
    np.testing.assert_allclose(np.asarray(out.image),
                               np.asarray(ref.image), atol=1e-5)
    assert int(out.num_pairs) == int(ref.num_pairs)


def test_decode_wide_unmasked_footprints():
    # The nx field is 6 bits (max_tiles_per_axis <= 32) with the mask
    # flag at bit 30: a 32-wide unmasked rectangle must decode row-major
    # without bleeding into the flag.
    x0, y0, nx = 100, 200, 32
    geom = jnp.int32(x0 | (y0 << 12) | (nx << 24))
    r = jnp.array([0, 31, 32, 32 * 17 + 5], jnp.int32)
    tx, ty = binning._pair_tile_decode(
        jnp.full((4,), geom), jnp.zeros((4,), jnp.int32),
        jnp.zeros((4,), jnp.int32), r)
    assert [int(v) for v in tx] == [100, 131, 100, 105]
    assert [int(v) for v in ty] == [200, 200, 201, 217]
