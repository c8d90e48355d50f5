"""Tiled framebuffer model: image <-> tile coordinate algebra.

Counterpart of the reference TiledFramebuffer
(include/tileMapping/tile_config.hpp:19-139). The reference pins one 32x20
pixel region per IPU tile and routes gaussians between neighbouring tiles
with greedy Manhattan steps (getBestDirection, tile_config.hpp:92-110).
Here tiles are cells of a Pallas grid; the routing helpers are kept (in
vectorized jnp form) because tests and telemetry use them, but frame-to-frame
migration is replaced by exact per-frame binning (see render/binning.py).

All functions are shape-polymorphic jnp and work both on host (numpy inputs)
and inside jit.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from gaussian_splat_ipu_tpu.utils.config import RasterConfig

# Direction encoding, reference include/splat/ipu_geometry.hpp:94-100.
LEFT, RIGHT, UP, DOWN, NONE = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class TiledFramebuffer:
    """Pixel <-> tile arithmetic for a statically tiled framebuffer.

    Mirrors the reference API surface (tile_config.hpp:43-126):
    pix_coord_to_tile, tile_bounds, nearby_tile, best_direction,
    check_image_boundaries.
    """

    width: int
    height: int
    tile_width: int
    tile_height: int

    @classmethod
    def from_config(cls, cfg: RasterConfig) -> "TiledFramebuffer":
        return cls(cfg.padded_width, cfg.padded_height, cfg.tile_width,
                   cfg.tile_height)

    @property
    def tiles_x(self) -> int:
        return self.width // self.tile_width

    @property
    def tiles_y(self) -> int:
        return self.height // self.tile_height

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    # -- pixel -> tile (reference tile_config.hpp:43-54) -----------------
    def pix_coord_to_tile(self, y, x):
        """Row-major tile index of pixel (y, x); -1 if out of bounds."""
        y = jnp.asarray(y)
        x = jnp.asarray(x)
        tx = jnp.floor_divide(x.astype(jnp.int32), self.tile_width)
        ty = jnp.floor_divide(y.astype(jnp.int32), self.tile_height)
        tid = ty * self.tiles_x + tx
        ok = (x >= 0) & (x < self.width) & (y >= 0) & (y < self.height)
        return jnp.where(ok, tid, -1)

    # -- tile -> pixel bounds (reference tile_config.hpp:57-71) ----------
    def tile_bounds(self, tid):
        """Returns (x0, y0, x1, y1) pixel bounds of tile tid (exclusive max)."""
        tid = jnp.asarray(tid, jnp.int32)
        ty, tx = jnp.divmod(tid, self.tiles_x)
        x0 = tx * self.tile_width
        y0 = ty * self.tile_height
        return x0, y0, x0 + self.tile_width, y0 + self.tile_height

    def tile_centroid(self, tid):
        x0, y0, x1, y1 = self.tile_bounds(tid)
        return (x0 + x1) * 0.5, (y0 + y1) * 0.5

    # -- neighbour tile in a direction (reference tile_config.hpp:73-86) -
    def nearby_tile(self, tid, direction):
        tid = jnp.asarray(tid, jnp.int32)
        direction = jnp.asarray(direction, jnp.int32)
        ty, tx = jnp.divmod(tid, self.tiles_x)
        dx = jnp.where(direction == LEFT, -1, jnp.where(direction == RIGHT, 1, 0))
        dy = jnp.where(direction == UP, -1, jnp.where(direction == DOWN, 1, 0))
        nx, ny = tx + dx, ty + dy
        ok = (nx >= 0) & (nx < self.tiles_x) & (ny >= 0) & (ny < self.tiles_y)
        return jnp.where(ok, ny * self.tiles_x + nx, tid)

    # -- greedy Manhattan routing (reference tile_config.hpp:92-110) -----
    def best_direction(self, src_xy, dst_xy):
        """Direction of the largest axis gap from src pixel centre to dst.

        src_xy/dst_xy: (..., 2) float pixel coords (x, y). Returns NONE when
        already on the same tile cell along both axes.
        """
        src = jnp.asarray(src_xy, jnp.float32)
        dst = jnp.asarray(dst_xy, jnp.float32)
        dx = dst[..., 0] - src[..., 0]
        dy = dst[..., 1] - src[..., 1]
        horiz = jnp.where(dx < 0, LEFT, RIGHT)
        vert = jnp.where(dy < 0, UP, DOWN)
        pick_h = jnp.abs(dx) >= jnp.abs(dy)
        d = jnp.where(pick_h, horiz, vert)
        same = (jnp.abs(dx) < self.tile_width / 2) & (
            jnp.abs(dy) < self.tile_height / 2)
        return jnp.where(same, NONE, d)

    # -- boundary test (reference tile_config.hpp:116-126) ---------------
    def check_image_boundaries(self, tid):
        """Returns (at_left, at_right, at_top, at_bottom) bool arrays."""
        tid = jnp.asarray(tid, jnp.int32)
        ty, tx = jnp.divmod(tid, self.tiles_x)
        return (tx == 0, tx == self.tiles_x - 1, ty == 0, ty == self.tiles_y - 1)


def tile_image(img: jnp.ndarray, fb: TiledFramebuffer) -> jnp.ndarray:
    """(H, W, C) raster image -> (num_tiles, tile_h*tile_w, C) tile order.

    Counterpart of the reference host-side tiling (ipu_rasteriser.cpp:115-129).
    A pure reshape/transpose, fused by XLA.
    """
    h, w = fb.height, fb.width
    c = img.shape[-1]
    x = img.reshape(fb.tiles_y, fb.tile_height, fb.tiles_x, fb.tile_width, c)
    x = x.transpose(0, 2, 1, 3, 4)
    return x.reshape(fb.num_tiles, fb.tile_height * fb.tile_width, c)


def untile_image(tiles: jnp.ndarray, fb: TiledFramebuffer) -> jnp.ndarray:
    """(num_tiles, tile_h*tile_w, C) -> (H, W, C) raster image.

    Counterpart of IpuSplatter::tileImageBuffer's inverse
    (reference src/splat/ipu_rasteriser.cpp:115-144).
    """
    c = tiles.shape[-1]
    x = tiles.reshape(fb.tiles_y, fb.tiles_x, fb.tile_height, fb.tile_width, c)
    x = x.transpose(0, 2, 1, 3, 4)
    return x.reshape(fb.height, fb.width, c)


def tile_histogram(counts: jnp.ndarray, fb: TiledFramebuffer) -> np.ndarray:
    """Per-tile workload histogram as a (tiles_y, tiles_x) grid.

    Parity with the reference's per-tile splat counters streamed to the UI
    (src/splat/ipu_rasteriser.cpp:321-324, src/main/splat.cpp:211-224).
    """
    return np.asarray(counts).reshape(fb.tiles_y, fb.tiles_x)
