"""Full render pipeline: project -> bin -> rasterize -> image.

The equivalent of the reference's per-frame "project" program
(src/splat/ipu_rasteriser.cpp:393-405: broadcast MVP; run GSplat on every
tile; run the exchange lattice; stream back the framebuffer) — except the
whole thing is one jitted XLA program per frame with exact per-frame
binning, and the framebuffer never leaves the device unless asked.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu.render import binning, tile_raster
from gaussian_splat_ipu_tpu.render.projection import (ProjectedSplats,
                                                      project_gaussians)
from gaussian_splat_ipu_tpu.utils.config import RasterConfig


class RenderOutput(NamedTuple):
    image: jnp.ndarray        # (H, W, 4) f32 RGBA (alpha = coverage)
    # (T,) i32 pairs composited per tile. With cfg.tile_group > 1 every
    # member tile reports its GROUP's range (its actual compositing
    # work); `truncated` below is deduped to one tally per group.
    tile_counts: jnp.ndarray
    overflow: jnp.ndarray     # () i32 dropped pairs (capacity exceeded)
    num_pairs: jnp.ndarray    # () i32 live (gaussian, tile) pairs
    visible: jnp.ndarray      # (N,) bool, gaussian survived frustum cull
    # Pairs past the per-tile max_chunks_per_tile * chunk_size work bound:
    # the rasterizer composits only that prefix of each tile's depth range
    # (the farthest splats drop — reference guarded-overflow discipline,
    # codelets.cpp:487-490). Nonzero means raise max_chunks_per_tile.
    truncated: jnp.ndarray    # () i32


def _untile_crop(tiles: jnp.ndarray, cfg: RasterConfig) -> jnp.ndarray:
    """(T, NPIX, 4) tile buffers -> (H, W, 4) cropped raster image."""
    c = tiles.shape[-1]
    x = tiles.reshape(cfg.tiles_y, cfg.tiles_x, cfg.tile_height,
                      cfg.tile_width, c)
    x = x.transpose(0, 2, 1, 3, 4).reshape(cfg.padded_height,
                                           cfg.padded_width, c)
    return x[:cfg.image_height, :cfg.image_width]


def truncated_pairs(counts: jnp.ndarray, cfg: RasterConfig,
                    row_lo=0) -> jnp.ndarray:
    """Pairs past the per-range work bound (max_chunks_per_range *
    chunk_size), tallied once per tile group: with tile_group > 1 every
    member tile reports its group's range. counts are per-tile range
    lengths of tile rows starting at row_lo (traced ok)."""
    over = jnp.maximum(counts - cfg.max_chunks_per_range * cfg.chunk_size,
                       0)
    g = cfg.tile_group
    if g > 1:
        idx = jnp.arange(counts.shape[0])
        rep = (((row_lo + idx // cfg.tiles_x) % g == 0)
               & ((idx % cfg.tiles_x) % g == 0))
        over = jnp.where(rep, over, 0)
    return jnp.sum(over)


def render(model: GaussianModel, camera: Camera, cfg: RasterConfig,
           use_pallas: bool = True,
           xy_probe: jnp.ndarray | None = None) -> RenderOutput:
    """Render one frame. Jit with static cfg/use_pallas:

        jit_render = jax.jit(render, static_argnums=(2, 3))
    """
    return render_splats(project_gaussians(model, camera, cfg,
                                           xy_probe=xy_probe),
                         cfg, use_pallas)


def render_splats(splats: ProjectedSplats, cfg: RasterConfig,
                  use_pallas: bool = True) -> RenderOutput:
    """Bin and rasterize already-projected splats: render() after its
    projection. Jit with static cfg/use_pallas."""
    binned = binning.bin_splats(splats, cfg)
    if use_pallas:
        from gaussian_splat_ipu_tpu.render.kernels import rasterize
        tiles = rasterize.rasterize_tiles(binned, cfg)
    else:
        tiles = tile_raster.rasterize_tiles_jnp(binned, cfg)
    image = _untile_crop(tiles, cfg)
    # With tile grouping, counts reports each tile's ACTUAL compositing
    # range (= its whole group's pairs) — honest work telemetry.
    counts = binned.tile_ends - binned.tile_starts
    return RenderOutput(image=image, tile_counts=counts,
                        overflow=binned.overflow, num_pairs=binned.num_pairs,
                        visible=splats.radius[:, 0] > 0.0,
                        truncated=truncated_pairs(counts, cfg))


def render_image(model: GaussianModel, camera: Camera,
                 cfg: RasterConfig, use_pallas: bool = True) -> jnp.ndarray:
    """(H, W, 4) image only — the differentiable entry point for training."""
    return render(model, camera, cfg, use_pallas).image


def render_depth(model: GaussianModel, camera: Camera, cfg: RasterConfig,
                 use_pallas: bool = True):
    """Alpha-composited depth map through the SAME tiled pipeline.

    Rides the colour channels: each splat's "colour" becomes
    (depth, depth^2, 0), so the compositor accumulates the first two
    depth moments with the usual alpha*T weights. Returns
    (mean_depth, depth_var, alpha), each (H, W):

        mean = E[d | hit],  var = E[d^2 | hit] - mean^2

    with pixels where alpha ~ 0 returning 0. Standard 3DGS tooling the
    reference never had (its framebuffer is colour-only,
    /root/reference/src/splat/ipu_rasteriser.cpp:393-405); useful for
    mesh extraction, depth supervision, and debugging. Differentiable,
    jit with static (2, 3).
    """
    import dataclasses
    if cfg.background != (0.0, 0.0, 0.0):
        cfg = dataclasses.replace(cfg, background=(0.0, 0.0, 0.0))
    splats = project_gaussians(model, camera, cfg)
    d = splats.depth
    depth_splats = splats._replace(
        color=jnp.stack([d, d * d, jnp.zeros_like(d)], axis=-1))
    img = render_splats(depth_splats, cfg, use_pallas).image
    alpha = img[..., 3]
    safe = jnp.maximum(alpha, 1e-8)
    mean = img[..., 0] / safe
    var = jnp.maximum(img[..., 1] / safe - mean * mean, 0.0)
    hit = alpha > 1e-6
    return (jnp.where(hit, mean, 0.0), jnp.where(hit, var, 0.0), alpha)
