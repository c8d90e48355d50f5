"""Distributed (shard_map) renderer tests on the virtual 8-device CPU mesh.

The reference has no multi-device path at all (single IPU, numReplicas
always 1 — SURVEY.md §2/§4); these validate the all_gather + row-strip
binning design of parallel/distributed.py against the single-device
pipeline, pixel-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu.parallel import distributed, mesh as meshlib
from gaussian_splat_ipu_tpu.render.pipeline import render
from gaussian_splat_ipu_tpu.train import trainer
from gaussian_splat_ipu_tpu.utils.config import RasterConfig

import pytest

# Heavy mesh/CLI integration tests: the fast tier is `pytest -m 'not slow'`
# (VERDICT r3 #7).
pytestmark = pytest.mark.slow


def _scene(seed=0, n=256, extent=1.0):
    model = GaussianModel.random(jax.random.PRNGKey(seed), n, extent=extent)
    camera = Camera.orbit(np.array([-1.0, -1.0, -1.0], np.float32) * extent,
                          np.array([1.0, 1.0, 1.0], np.float32) * extent,
                          fov_radians=np.radians(40.0), aspect=1.0)
    return model, camera


CFG = RasterConfig(image_width=96, image_height=96, pair_capacity=1 << 13,
                   max_chunks_per_tile=8)  # 3x3 tiles of 32x32


class TestShardedRender:
    def test_matches_single_device(self):
        model, camera = _scene()
        ref = render(model, camera, CFG, use_pallas=False)

        mesh = meshlib.make_mesh(8)
        sharded = meshlib.shard_model(model, mesh)
        out = distributed.render_sharded(sharded, camera, CFG, mesh,
                                         use_pallas=False,
                                         pair_capacity=1 << 13)
        assert int(out.overflow) == 0
        np.testing.assert_allclose(np.asarray(out.image),
                                   np.asarray(ref.image), atol=1e-5)

    def test_matches_with_pallas_interpret(self):
        model, camera = _scene(seed=2)
        ref = render(model, camera, CFG, use_pallas=True)
        mesh = meshlib.make_mesh(8)
        sharded = meshlib.shard_model(model, mesh)
        out = distributed.render_sharded(sharded, camera, CFG, mesh,
                                         use_pallas=True,
                                         pair_capacity=1 << 13)
        np.testing.assert_allclose(np.asarray(out.image),
                                   np.asarray(ref.image), atol=1e-5)

    def test_num_pairs_matches_single_device(self):
        model, camera = _scene(seed=4)
        ref = render(model, camera, CFG, use_pallas=False)
        mesh = meshlib.make_mesh(8)
        sharded = meshlib.shard_model(model, mesh)
        out = distributed.render_sharded(sharded, camera, CFG, mesh,
                                         use_pallas=False,
                                         pair_capacity=1 << 13)
        assert int(out.num_pairs) == int(ref.num_pairs)

    def test_uneven_rows(self):
        # 2 tile rows over 8 devices: 1 row per device, 6 devices idle.
        cfg = RasterConfig(image_width=64, image_height=64,
                           pair_capacity=1 << 12, max_chunks_per_tile=4)
        model, camera = _scene(seed=5, n=128)
        ref = render(model, camera, cfg, use_pallas=False)
        mesh = meshlib.make_mesh(8)
        sharded = meshlib.shard_model(model, mesh)
        out = distributed.render_sharded(sharded, camera, cfg, mesh,
                                         use_pallas=False,
                                         pair_capacity=1 << 12)
        np.testing.assert_allclose(np.asarray(out.image),
                                   np.asarray(ref.image), atol=1e-5)


class TestExchangeModes:
    """The per-destination all_to_all exchange (default) vs the all_gather
    fallback — the replacement for the reference's bounded
    lattice channels (src/splat/edge_builder.cpp:35-84)."""

    def test_all_to_all_matches_all_gather(self):
        model, camera = _scene(seed=11)
        mesh = meshlib.make_mesh(8)
        sharded = meshlib.shard_model(model, mesh)
        out_a2a = distributed.render_sharded(
            sharded, camera, CFG, mesh, use_pallas=False,
            pair_capacity=1 << 13, exchange="all_to_all")
        out_ag = distributed.render_sharded(
            sharded, camera, CFG, mesh, use_pallas=False,
            pair_capacity=1 << 13, exchange="all_gather")
        assert int(out_a2a.exchange_overflow) == 0
        assert int(out_ag.exchange_overflow) == 0
        np.testing.assert_allclose(np.asarray(out_a2a.image),
                                   np.asarray(out_ag.image), atol=1e-5)
        assert int(out_a2a.num_pairs) == int(out_ag.num_pairs)

    def test_exchange_overflow_counted_not_silent(self):
        # Starve the per-destination buckets: rows past capacity must be
        # COUNTED (bounded-channel discipline of the reference's 300-slot
        # lattice channels), never silently lost.
        model, camera = _scene(seed=12)
        mesh = meshlib.make_mesh(8)
        sharded = meshlib.shard_model(model, mesh)
        ref = distributed.render_sharded(
            sharded, camera, CFG, mesh, use_pallas=False,
            pair_capacity=1 << 13, exchange_capacity=4096)
        assert int(ref.exchange_overflow) == 0
        starved = distributed.render_sharded(
            sharded, camera, CFG, mesh, use_pallas=False,
            pair_capacity=1 << 13, exchange_capacity=1)
        # 128-row alignment makes the effective floor 128 rows/bucket; with
        # 256/8 = 32 local splats no bucket can overflow, but the d*cap
        # expansion table can't: only assert the counter plumbing is live
        # (zero here) and force a real overflow via a single-device mesh
        # where every splat routes to bucket 0.
        assert int(starved.exchange_overflow) >= 0
        mesh1 = meshlib.make_mesh(1)
        big = GaussianModel.random(jax.random.PRNGKey(13), 512, extent=0.2)
        sharded1 = meshlib.shard_model(big, mesh1)
        out1 = distributed.render_sharded(
            sharded1, camera, CFG, mesh1, use_pallas=False,
            pair_capacity=1 << 13, exchange_capacity=128)
        # Exact expected drop count: splats whose footprint touches the
        # framebuffer at all (span > 0) beyond the 128-row bucket.
        from gaussian_splat_ipu_tpu.render import binning
        from gaussian_splat_ipu_tpu.render.projection import (
            project_gaussians)
        sp = project_gaussians(big, camera, CFG)
        _, _, nx, ny = binning.tile_ranges_of(sp, CFG)
        n_routed = int(np.sum(np.asarray((nx > 0) & (ny > 0))))
        assert n_routed > 128, "scene too sparse to starve the bucket"
        assert int(out1.exchange_overflow) == n_routed - 128

    def test_uneven_shard_rows_all_to_all(self):
        # tiles_y=2 over 8 devices: most devices own zero real rows; the
        # routing span must still stay in-range and render exactly.
        cfg = RasterConfig(image_width=64, image_height=64,
                           pair_capacity=1 << 12, max_chunks_per_tile=4)
        model, camera = _scene(seed=14, n=128)
        ref = render(model, camera, cfg, use_pallas=False)
        mesh = meshlib.make_mesh(8)
        sharded = meshlib.shard_model(model, mesh)
        out = distributed.render_sharded(sharded, camera, cfg, mesh,
                                         use_pallas=False,
                                         pair_capacity=1 << 12,
                                         exchange="all_to_all")
        assert int(out.exchange_overflow) == 0
        np.testing.assert_allclose(np.asarray(out.image),
                                   np.asarray(ref.image), atol=1e-5)


class TestShardedGradients:
    def test_grads_match_single_device(self):
        from gaussian_splat_ipu_tpu.train import losses

        model, camera = _scene(seed=6, n=64)
        cfg = RasterConfig(image_width=64, image_height=64,
                           pair_capacity=1 << 12, max_chunks_per_tile=4)
        target = jnp.zeros((64, 64, 4), jnp.float32)

        def loss_single(m):
            from gaussian_splat_ipu_tpu.render.pipeline import render_image
            img = render_image(m, camera, cfg, use_pallas=False)
            return losses.l1(img[..., :3], target[..., :3])

        g_ref = jax.grad(loss_single)(model)

        mesh = meshlib.make_mesh(8)
        sharded = meshlib.shard_model(model, mesh)

        def loss_dist(m):
            img = distributed.render_image_sharded(
                m, camera, cfg, mesh, use_pallas=False,
                pair_capacity=1 << 12)
            return losses.l1(img[..., :3], target[..., :3])

        g_dist = jax.grad(loss_dist)(sharded)
        for name in ("means", "log_scales", "quats", "opacities", "sh"):
            np.testing.assert_allclose(
                np.asarray(getattr(g_dist, name)),
                np.asarray(getattr(g_ref, name)), atol=1e-5,
                err_msg=name)


class TestShardedTrainStep:
    def test_one_step(self):
        model, camera = _scene(seed=8, n=128)
        cfg = RasterConfig(image_width=64, image_height=64,
                           pair_capacity=1 << 12, max_chunks_per_tile=4)
        mesh = meshlib.make_mesh(8)
        sharded = meshlib.shard_model(model, mesh)
        means_before = np.asarray(sharded.means).copy()  # step donates state
        tc = trainer.TrainConfig(ssim_weight=0.0)
        state = trainer.init_state(sharded, tc)
        target = jnp.zeros((64, 64, 4), jnp.float32)
        step = distributed.make_sharded_train_step(mesh, cfg, tc,
                                                   use_pallas=False,
                                                   pair_capacity=1 << 12)
        new_state, loss = step(state, camera, target)
        assert np.isfinite(float(loss))
        assert int(new_state.step) == 1
        # Params actually moved.
        delta = np.abs(np.asarray(new_state.params.means)
                       - means_before).max()
        assert delta > 0.0


class TestShardedTileGroup:
    def test_grouped_strips_match_single_device(self):
        """tile_group on the distributed row-strip path: group-keyed
        binning per device strip reproduces the ungrouped single-device
        image (alpha-aware extents -> same composited set)."""
        import dataclasses

        model, camera = _scene(seed=7)
        # 4 cols x 8 rows of 16px tiles; 4 devices x 2 rows = aligned
        # 2x2 groups per strip.
        cfg = RasterConfig(image_width=64, image_height=128,
                           tile_width=16, tile_height=16,
                           pair_capacity=1 << 13, max_chunks_per_tile=8,
                           extent_sigma=0.0)
        ref = render(model, camera, cfg, use_pallas=False)

        mesh = meshlib.make_mesh(4)
        sharded = meshlib.shard_model(model, mesh)
        gcfg = dataclasses.replace(cfg, tile_group=2)
        out = distributed.render_sharded(sharded, camera, gcfg, mesh,
                                         use_pallas=False,
                                         pair_capacity=1 << 13)
        assert int(out.overflow) == 0
        np.testing.assert_allclose(np.asarray(out.image),
                                   np.asarray(ref.image), atol=1e-5)

    def test_group_unaligned_device_count(self):
        """8 tile rows over 8 devices with tile_group=2: strips are
        group-ALIGNED by rounding rows-per-device up to the group size
        (r5, VERDICT r4 #5) — devices 4-7 own only phantom rows — and
        the output still matches the ungrouped single-device render."""
        import dataclasses

        model, camera = _scene(seed=8, n=64)
        cfg = RasterConfig(image_width=64, image_height=128,
                           tile_width=16, tile_height=16,
                           pair_capacity=1 << 12, max_chunks_per_tile=8,
                           extent_sigma=0.0)
        ref = render(model, camera, cfg, use_pallas=False)
        mesh = meshlib.make_mesh(8)
        sharded = meshlib.shard_model(model, mesh)
        gcfg = dataclasses.replace(cfg, tile_group=2)
        out = distributed.render_sharded(sharded, camera, gcfg, mesh,
                                         use_pallas=False,
                                         pair_capacity=1 << 12)
        np.testing.assert_allclose(np.asarray(out.image),
                                   np.asarray(ref.image), atol=1e-5)

    def test_winner_config_720p_8dev_matches_single(self):
        """A grouped config (tile_group=2 + exact_tile_test)
        at the flagship 1280x720 geometry on an 8-device mesh (45 tile
        rows -> 6-row group-aligned strips + phantom tail) reproduces
        the single-device render (VERDICT r4 #5 'Done' criterion).

        Tolerance note: the BINNING is bit-exact across strip splits on
        identical projected inputs (test below); the end-to-end image
        is compared to one alpha-quantum (1/255) because projection and
        compositing compile as DIFFERENT XLA programs single-device vs
        shard_map — f32 reassociation differs, and a 1-ulp conic/depth
        change can flip a pair across the alpha_min=1/255 skip
        threshold. Measured: max |diff| == 1/255 exactly, relative
        <= transmittance_eps, identical for all_gather (global set,
        global order) and all_to_all — i.e. numerics, not routing."""
        model, camera = _scene(seed=9, n=384)
        cfg = RasterConfig(image_width=1280, image_height=720,
                           pair_capacity=1 << 13, max_chunks_per_tile=8,
                           tile_group=2, exact_tile_test=True)
        ref = render(model, camera, cfg, use_pallas=False)
        mesh = meshlib.make_mesh(8)
        sharded = meshlib.shard_model(model, mesh)
        out = distributed.render_sharded(sharded, camera, cfg, mesh,
                                         use_pallas=False,
                                         pair_capacity=1 << 13)
        assert int(out.overflow) == 0
        np.testing.assert_allclose(np.asarray(out.image),
                                   np.asarray(ref.image),
                                   atol=1.01 / 255)

    def test_winner_config_strip_binning_bit_exact(self):
        """Row-strip binning (the per-device path) is BIT-identical to
        full-grid binning per covered tile on the same projected
        inputs, in the winner config at 720p with the r5 group-aligned
        6-row strips — the invariant the renderer controls (the image
        tolerance above is pure cross-program float reassociation)."""
        from gaussian_splat_ipu_tpu.render import binning
        from gaussian_splat_ipu_tpu.render.projection import (
            project_gaussians)

        model, camera = _scene(seed=9, n=384)
        cfg = RasterConfig(image_width=1280, image_height=720,
                           pair_capacity=1 << 13, max_chunks_per_tile=8,
                           tile_group=2, exact_tile_test=True)
        sp = project_gaussians(model, camera, cfg)
        full = binning.bin_splats(sp, cfg)
        f1 = np.asarray(full.features)
        s1 = np.asarray(full.tile_starts)
        e1 = np.asarray(full.tile_ends)
        rows = distributed._rows_per_device(cfg, 8)
        assert rows % cfg.tile_group == 0
        ntx = cfg.tiles_x
        for dev in range(8):
            row_lo = dev * rows
            bb = binning.bin_splats(sp, cfg, row_lo=row_lo,
                                    num_rows=rows,
                                    pair_capacity=cfg.pair_capacity)
            f2 = np.asarray(bb.features)
            s2 = np.asarray(bb.tile_starts)
            e2 = np.asarray(bb.tile_ends)
            for li in range(rows * ntx):
                r = row_lo + li // ntx
                if r >= cfg.tiles_y:
                    continue
                t = r * ntx + li % ntx
                a = f1[:10, s1[t]:e1[t]]
                c = f2[:10, s2[li]:e2[li]]
                assert a.shape == c.shape and (a == c).all(), \
                    f"tile {t} strip-vs-full mismatch"
