"""Point-splat renderer: the positional sanity path.

Parity with the reference's CPU rasteriser (src/splat/cpu_rasteriser.cpp:
9-63): project all points with the MVP, perspective-divide to the viewport,
and additively splat a single pixel per point, counting how many landed
on-screen. The reference uses this as a runtime-switchable device for visual
sanity checks (src/main/splat.cpp:250-256); ours is additionally jittable
and runs on the device (scatter-add instead of OpenMP atomics).

Also provides the per-tile workload histogram of cpu_rasteriser.cpp:65-92.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu.ops import transforms
from gaussian_splat_ipu_tpu.utils.config import RasterConfig


class PointRenderOutput(NamedTuple):
    image: jnp.ndarray  # (H, W, 4) f32
    count: jnp.ndarray  # () i32 on-screen points


def render_points(model: GaussianModel, camera: Camera, cfg: RasterConfig,
                  color=(1.0, 1.0, 1.0)) -> PointRenderOutput:
    """1-px additive point splat of every gaussian centre."""
    h, w = cfg.image_height, cfg.image_width
    clip = transforms.transform_points(camera.view_proj, model.means)
    xy = transforms.clip_to_screen(clip, w, h)
    x = jnp.round(xy[:, 0]).astype(jnp.int32)
    y = jnp.round(xy[:, 1]).astype(jnp.int32)
    # Visibility: in front of the camera and inside the viewport (the
    # reference clips in Viewport::clipSpaceToViewport + bounds test,
    # cpu_rasteriser.cpp:38-55).
    vis = ((clip[:, 3] > 1e-6) & (x >= 0) & (x < w) & (y >= 0) & (y < h))
    flat = jnp.where(vis, y * w + x, 0)
    add = vis.astype(jnp.float32)  # masked points add 0 at pixel 0
    img = jnp.zeros((h * w,), jnp.float32).at[flat].add(add, mode="drop")
    rgb = jnp.asarray(color, jnp.float32)
    image = jnp.clip(img, 0.0, 1.0)[:, None] * rgb[None, :]
    alpha = jnp.clip(img, 0.0, 1.0)[:, None]
    out = jnp.concatenate([image, alpha], -1).reshape(h, w, 4)
    return PointRenderOutput(image=out, count=jnp.sum(vis,
                                                      dtype=jnp.int32))


def tile_histogram(model: GaussianModel, camera: Camera,
                   cfg: RasterConfig) -> jnp.ndarray:
    """(T,) i32 count of point centres per framebuffer tile.

    Parity with buildTileHistogram (cpu_rasteriser.cpp:65-92) — the
    load-balance telemetry the reference streams to its UI.
    """
    h, w = cfg.image_height, cfg.image_width
    clip = transforms.transform_points(camera.view_proj, model.means)
    xy = transforms.clip_to_screen(clip, w, h)
    # Same rounding + bounds rule as render_points so the histogram total
    # equals the splatted count (the reference counts both the same way).
    x = jnp.round(xy[:, 0]).astype(jnp.int32)
    y = jnp.round(xy[:, 1]).astype(jnp.int32)
    vis = ((clip[:, 3] > 1e-6) & (x >= 0) & (x < w) & (y >= 0) & (y < h))
    x = jnp.clip(x, 0, w - 1)
    y = jnp.clip(y, 0, h - 1)
    tid = ((y // cfg.tile_height) * cfg.tiles_x + (x // cfg.tile_width))
    hist = jnp.zeros((cfg.num_tiles,), jnp.int32)
    return hist.at[jnp.where(vis, tid, 0)].add(
        vis.astype(jnp.int32), mode="drop")
