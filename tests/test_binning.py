"""Binning tests: tile coverage, sort order, CSR ranges, overflow."""

import numpy as np
import jax.numpy as jnp

from gaussian_splat_ipu_tpu.render import binning
from gaussian_splat_ipu_tpu.render.projection import ProjectedSplats
from gaussian_splat_ipu_tpu.utils.config import RasterConfig

import pytest

CFG = RasterConfig(image_width=128, image_height=64, tile_width=32,
                   tile_height=32, pair_capacity=256, chunk_size=8,
                   max_chunks_per_tile=32)
# 4x2 = 8 tiles.


def make_splats(xy, radius, depth=None, opacity=0.9):
    n = len(xy)
    xy = np.asarray(xy, np.float32)
    depth = np.arange(1, n + 1, dtype=np.float32) if depth is None else \
        np.asarray(depth, np.float32)
    return ProjectedSplats(
        xy=jnp.asarray(xy),
        depth=jnp.asarray(depth),
        conic=jnp.tile(jnp.array([[1.0, 0.0, 1.0]], jnp.float32), (n, 1)),
        color=jnp.tile(jnp.array([[1.0, 0.5, 0.25]], jnp.float32), (n, 1)),
        opacity=jnp.full((n,), opacity, jnp.float32),
        radius=jnp.stack([jnp.asarray(radius, jnp.float32)] * 2, -1),
    )


def test_single_tile_coverage():
    # Small gaussian in the middle of tile (1, 0) -> exactly one pair.
    s = make_splats([[48.0, 16.0]], [3.0])
    b = binning.bin_splats(s, CFG)
    assert int(b.num_pairs) == 1
    starts = np.asarray(b.tile_starts)
    ends = np.asarray(b.tile_ends)
    counts = ends - starts
    assert counts.sum() == 1
    assert counts[1] == 1  # tile id 1 = (tx=1, ty=0)


def test_multi_tile_coverage():
    # Radius spanning 2x2 tiles around the (32, 32) corner.
    s = make_splats([[32.0, 32.0]], [5.0])
    b = binning.bin_splats(s, CFG)
    counts = np.asarray(b.tile_ends - b.tile_starts)
    assert int(b.num_pairs) == 4
    assert counts[0] == 1 and counts[1] == 1  # tiles (0,0), (1,0)
    assert counts[4] == 1 and counts[5] == 1  # tiles (0,1), (1,1)


def test_culled_gaussian_no_pairs():
    s = make_splats([[48.0, 16.0]], [0.0])  # radius 0 => culled
    b = binning.bin_splats(s, CFG)
    assert int(b.num_pairs) == 0
    assert int((np.asarray(b.tile_ends) - np.asarray(b.tile_starts)).sum()) \
        == 0


def test_depth_sorted_within_tile():
    # Three gaussians on one tile with shuffled depths.
    s = make_splats([[16.0, 16.0], [17.0, 16.0], [18.0, 16.0]],
                    [2.0, 2.0, 2.0], depth=[3.0, 1.0, 2.0])
    b = binning.bin_splats(s, CFG)
    start, end = int(b.tile_starts[0]), int(b.tile_ends[0])
    assert end - start == 3
    depths = np.asarray(b.features[binning.FEAT_DEPTH, start:end])
    assert np.all(np.diff(depths) >= 0)
    gids = np.asarray(b.pair_gid[start:end])
    np.testing.assert_array_equal(gids, [1, 2, 0])


def test_pad_pairs_have_zero_opacity():
    s = make_splats([[16.0, 16.0]], [2.0])
    b = binning.bin_splats(s, CFG)
    op = np.asarray(b.features[binning.FEAT_OPACITY])
    assert op[0] > 0
    np.testing.assert_allclose(op[1:], 0.0)
    assert int(b.pair_gid[1]) == 1  # == N marks padding


@pytest.mark.slow
def test_overflow_counted():
    cfg = RasterConfig(image_width=128, image_height=64, tile_width=32,
                       tile_height=32, pair_capacity=8, chunk_size=8)
    # 10 gaussians, one tile each -> demand 10 > capacity 8.
    xy = [[14.0 + 0.5 * i, 16.0] for i in range(10)]
    s = make_splats(xy, [1.0] * 10)
    b = binning.bin_splats(s, cfg)
    assert int(b.overflow) == 2
    assert int(b.num_pairs) == 8


def test_offscreen_clamped_to_grid():
    # Gaussian centred off-screen with big radius: tiles clamp to grid.
    s = make_splats([[-10.0, -10.0]], [20.0])
    b = binning.bin_splats(s, CFG)
    counts = np.asarray(b.tile_ends - b.tile_starts)
    assert int(b.num_pairs) == 1
    assert counts[0] == 1


def test_fused_key_matches_exact_sort():
    """Fused single-key sort == exact two-pass sort when depths are
    separated by more than the quantization resolution."""
    import dataclasses
    rng = np.random.default_rng(11)
    n = 64
    xy = rng.uniform(0, [128, 64], (n, 2)).astype(np.float32)
    # Well-separated depths (random permutation of 1..n).
    depth = rng.permutation(np.arange(1, n + 1)).astype(np.float32)
    s = make_splats(xy.tolist(), [3.0] * n, depth=depth.tolist())
    b_fused = binning.bin_splats(s, CFG)
    b_exact = binning.bin_splats(
        s, dataclasses.replace(CFG, fused_sort_key=False))
    np.testing.assert_array_equal(np.asarray(b_fused.pair_gid),
                                  np.asarray(b_exact.pair_gid))
    np.testing.assert_allclose(np.asarray(b_fused.features),
                               np.asarray(b_exact.features))
    np.testing.assert_array_equal(np.asarray(b_fused.tile_starts),
                                  np.asarray(b_exact.tile_starts))
    np.testing.assert_array_equal(np.asarray(b_fused.tile_ends),
                                  np.asarray(b_exact.tile_ends))


def test_fused_key_gradients_flow():
    """The fused table's custom VJP scatter-adds cotangents per gaussian
    identically to the exact path's."""
    import dataclasses
    import jax

    s = make_splats([[16.0, 16.0], [48.0, 16.0], [17.0, 17.0]],
                    [2.0, 2.0, 2.0], depth=[2.0, 1.0, 3.0])

    def loss_with(cfg):
        def f(opacity):
            b = binning.bin_splats(s._replace(opacity=opacity), cfg)
            return jnp.sum(b.features[binning.FEAT_OPACITY]
                           * b.features[binning.FEAT_DEPTH])
        return jax.grad(f)(s.opacity)

    g_fused = loss_with(CFG)
    g_exact = loss_with(dataclasses.replace(CFG, fused_sort_key=False))
    np.testing.assert_allclose(np.asarray(g_fused), np.asarray(g_exact),
                               rtol=1e-6)
    assert np.abs(np.asarray(g_fused)).max() > 0


def test_huge_tile_grid_falls_back_to_exact_sort():
    """num_tiles too large for a fused (tile, depth) i32 key -> the exact
    two-pass path is selected and still bins correctly."""
    cfg = RasterConfig(image_width=4096, image_height=1024, tile_width=8,
                       tile_height=8, pair_capacity=256, chunk_size=8,
                       max_chunks_per_tile=8)
    assert 31 - (cfg.num_tiles + 1).bit_length() < 16  # forces fallback
    s = make_splats([[4.0, 4.0], [12.0, 4.0]], [2.0, 2.0],
                    depth=[2.0, 1.0])
    b = binning.bin_splats(s, cfg)
    assert int(b.num_pairs) == 2
    assert int(b.overflow) == 0
    # Each gaussian lands on its own tile, correct CSR ranges.
    assert int(b.tile_ends[0] - b.tile_starts[0]) == 1
    assert int(b.tile_ends[1] - b.tile_starts[1]) == 1


def test_fused_pad_sentinel_clears_phantom_rows():
    """Uneven row sharding: the last device's CSR queries include phantom
    tile ids past the grid; pads must sort AFTER all of them (regression:
    a 2^tile_bits-1 sentinel equal to a phantom tid swallowed the pad
    tail into that tile's range)."""
    cfg = RasterConfig(image_width=800, image_height=320, tile_width=8,
                       tile_height=8, pair_capacity=256, chunk_size=8,
                       max_chunks_per_tile=8)
    assert cfg.tiles_x == 100 and cfg.tiles_y == 40  # num_tiles = 4000
    # 3-way sharding: 14 rows/device; device 2 covers rows 28..41 where
    # rows 40-41 are phantom (tids 4000..4199 get queried).
    s = make_splats([[4.0, 300.0]], [2.0])  # one real pair in row 37
    b = binning.bin_splats(s, cfg, row_lo=28, num_rows=14,
                           pair_capacity=256)
    counts = np.asarray(b.tile_ends - b.tile_starts)
    assert counts.sum() == 1  # only the real pair, nothing from pads
    # Phantom-row tiles (local rows 12-13) are all empty.
    assert counts[12 * 100:].sum() == 0


def test_presort_matches_exact_sort():
    """Depth-presorted tile-only sort == exact two-pass (tile, depth)
    sort: same pairs, same order, same CSR ranges (the presort keeps
    EXACT f32 depth order, unlike the quantized fused key)."""
    import dataclasses
    rng = np.random.default_rng(13)
    n = 96
    xy = rng.uniform(0, [128, 64], (n, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 50.0, n).astype(np.float32)
    s = make_splats(xy.tolist(), rng.uniform(1, 6, n).tolist(),
                    depth=depth.tolist())
    b_pre = binning.bin_splats(
        s, dataclasses.replace(CFG, presort_depth=True))
    b_exact = binning.bin_splats(
        s, dataclasses.replace(CFG, fused_sort_key=False))
    np.testing.assert_array_equal(np.asarray(b_pre.pair_gid),
                                  np.asarray(b_exact.pair_gid))
    np.testing.assert_allclose(np.asarray(b_pre.features),
                               np.asarray(b_exact.features))
    np.testing.assert_array_equal(np.asarray(b_pre.tile_starts),
                                  np.asarray(b_exact.tile_starts))
    np.testing.assert_array_equal(np.asarray(b_pre.tile_ends),
                                  np.asarray(b_exact.tile_ends))
    assert int(b_pre.num_pairs) == int(b_exact.num_pairs)


@pytest.mark.slow
def test_presort_gradients_match_exact():
    import dataclasses
    import jax

    rng = np.random.default_rng(14)
    n = 24
    xy = rng.uniform(0, [128, 64], (n, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 9.0, n).astype(np.float32)
    s = make_splats(xy.tolist(), rng.uniform(1, 4, n).tolist(),
                    depth=depth.tolist())

    def loss_with(cfg):
        def f(opacity):
            b = binning.bin_splats(s._replace(opacity=opacity), cfg)
            return jnp.sum(b.features[binning.FEAT_OPACITY]
                           * (1.0 + b.features[binning.FEAT_R]))
        return f

    g_pre = jax.grad(loss_with(
        dataclasses.replace(CFG, presort_depth=True)))(s.opacity)
    g_exact = jax.grad(loss_with(
        dataclasses.replace(CFG, fused_sort_key=False)))(s.opacity)
    np.testing.assert_allclose(np.asarray(g_pre), np.asarray(g_exact),
                               atol=1e-6)


@pytest.mark.slow
def test_presort_end_to_end_render_matches():
    import dataclasses

    import jax

    from gaussian_splat_ipu_tpu.models.camera import Camera
    from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu.render.pipeline import render

    cfg = RasterConfig(image_width=96, image_height=96,
                       pair_capacity=1 << 13, max_chunks_per_tile=8)
    model = GaussianModel.random(jax.random.PRNGKey(3), 256, extent=1.0)
    cam = Camera.orbit(np.array([-1, -1, -1], np.float32),
                       np.array([1, 1, 1], np.float32),
                       fov_radians=np.radians(40.0), aspect=1.0)
    a = np.asarray(render(model, cam, cfg, use_pallas=False).image)
    b = np.asarray(render(
        model, cam, dataclasses.replace(cfg, presort_depth=True),
        use_pallas=False).image)
    np.testing.assert_allclose(a, b, atol=2e-5)


@pytest.mark.slow
def test_randomized_invariants_across_configs():
    """Randomized sweep over sort strategies x tile grouping: structural
    invariants of BinnedSplats hold for every combination.

    Invariants: CSR ranges are well-formed and within capacity;
    num_pairs == total live coverage (when under capacity); overflow
    complements it; pad pairs render as alpha 0; grouped binning never
    creates more pairs than ungrouped; depth is non-decreasing within
    every tile's range (exact/presort paths)."""
    import dataclasses

    rng = np.random.default_rng(11)
    n = 40
    xy = rng.uniform(-10, 138, (n, 2)).astype(np.float32)   # some offscreen
    radius = rng.uniform(0.0, 40.0, n).astype(np.float32)
    radius[rng.random(n) < 0.2] = 0.0                        # some culled
    depth = rng.uniform(0.1, 9.0, n).astype(np.float32)
    splats = make_splats(xy, radius, depth)

    base_pairs = None
    for presort, fused in ((False, False), (False, True), (True, True)):
        for group in (1, 2):
            cfg = dataclasses.replace(CFG, presort_depth=presort,
                                      fused_sort_key=fused,
                                      tile_group=group)
            out = binning.bin_splats(splats, cfg)
            starts = np.asarray(out.tile_starts)
            ends = np.asarray(out.tile_ends)
            p = cfg.pair_capacity
            tag = (presort, fused, group)

            assert ((0 <= starts) & (starts <= ends) & (ends <= p)).all(), tag
            npairs = int(out.num_pairs)
            assert 0 <= npairs <= p, tag
            assert int(out.overflow) >= 0, tag

            # Pad tail renders invisible. features is feature-major
            # (TABLE_ROWS, P): each feature row is contiguous along pairs.
            feats = np.asarray(out.features)
            gid = np.asarray(out.pair_gid)
            pad_rows = gid >= n
            assert (feats[8, pad_rows] == 0.0).all(), tag  # opacity row

            if group == 1:
                base_pairs = npairs
                # Exact/presort depth order within each tile range.
                if not fused or presort:
                    d = feats[9, :]
                    for s, e in zip(starts, ends):
                        seg = d[s:e]
                        assert (np.diff(seg) >= -1e-6).all(), tag
            else:
                assert npairs <= base_pairs, tag
