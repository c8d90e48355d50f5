"""Tiled rasterization, chunked-scan formulation (pure jnp).

This is the mathematical specification of the rasterize kernels
(render/kernels/rasterize.py): the same front-to-back compositing,
expressed with lax.scan + cumprod so JAX autodiff produces exact gradients.
The kernels walk a tile's pairs one at a time; this spec processes them in
depth-ordered chunks of C. Within a chunk, per-pixel transmittance
prefixes are

    T_i = T_in * prod_{j<i} (1 - a_j)

one (NPIX, C) cumprod, and the colour accumulation sum_i w_i * rgb_i is one
(NPIX, C) @ (C, 3) matmul. The spec has no early exit: it scans all
max_chunks_per_range chunks of every tile.
The reference's exact break semantics (codelets.cpp:389-411: skip when
power>0 or alpha<1/255; break *before* blending when T*(1-a) < 1e-4) are
reproduced with masks; skipped gaussians never trigger the break.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gaussian_splat_ipu_tpu.render import binning as B
from gaussian_splat_ipu_tpu.utils.config import RasterConfig


def chunk_alphas(chunk: jnp.ndarray, px: jnp.ndarray, py: jnp.ndarray,
                 valid: jnp.ndarray, cfg: RasterConfig) -> jnp.ndarray:
    """Evaluate per-(pixel, gaussian) alpha for one feature chunk.

    chunk: (TABLE_ROWS, C); px/py: (NPIX, 1); valid: (C,) bool.
    Returns (NPIX, C) alpha with all skip rules applied (zero = skip).
    """
    gx = chunk[B.FEAT_X][None, :]
    gy = chunk[B.FEAT_Y][None, :]
    ca = chunk[B.FEAT_CONIC_A][None, :]
    cb = chunk[B.FEAT_CONIC_B][None, :]
    cc = chunk[B.FEAT_CONIC_C][None, :]
    op = chunk[B.FEAT_OPACITY][None, :]
    dx = gx - px
    dy = gy - py
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = jnp.minimum(cfg.alpha_clamp, op * jnp.exp(power))
    skip = (power > 0.0) | (alpha < cfg.alpha_min) | ~valid[None, :]
    return jnp.where(skip, 0.0, alpha)


def composite_chunk(t_in, stopped_in, alpha, rgb, cfg: RasterConfig):
    """Front-to-back composite one chunk with exact break semantics.

    t_in: (NPIX, 1) transmittance entering the chunk.
    stopped_in: (NPIX, 1) bool, pixels already terminated.
    alpha: (NPIX, C); rgb: (C, 3).
    Returns (color_add (NPIX, 3), t_out, stopped_out).
    """
    # Multiplicative domain: T prefixes are cumulative products of (1 - a)
    # directly (no log1p/exp round trip — the kernels multiply too, so both
    # stay allclose).
    one_minus = 1.0 - alpha
    incl = jnp.cumprod(one_minus, axis=1)                # (NPIX, C)
    t_pre = t_in * jnp.concatenate(
        [jnp.ones_like(incl[:, :1]), incl[:, :-1]], axis=1)  # exclusive
    test_t = t_in * incl
    # Break triggers only on contributing gaussians (alpha > 0), matching
    # the reference's continue-before-test ordering (codelets.cpp:389-408).
    # test_t is monotone non-increasing along the chunk, so "any trigger at
    # or before i" collapses to the elementwise test: elements past the
    # first trigger either fail it themselves (alpha > 0) or contribute
    # nothing (alpha == 0).
    trig = (test_t < cfg.transmittance_eps) & (alpha > 0.0)
    live = (~trig) & (~stopped_in)
    w = alpha * t_pre * live.astype(jnp.float32)         # (NPIX, C)
    # Full-precision contraction: this path is the gradient spec, and a
    # reduced-precision default (TF32, bf16 passes) would introduce ~1e-3
    # colour error.
    color_add = jnp.dot(w, rgb, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
    chunk_any = jnp.any(trig, axis=1, keepdims=True)
    # The transmittance freezes at the FIRST trigger's prefix (the break
    # happens before blending it); first trigger = largest such t_pre.
    frozen = jnp.max(t_pre * trig.astype(jnp.float32), axis=1,
                     keepdims=True)
    t_out = jnp.where(stopped_in, t_in,
                      jnp.where(chunk_any, frozen, t_in * incl[:, -1:]))
    stopped_out = stopped_in | chunk_any
    return color_add, t_out, stopped_out


def _pixel_coords(cfg: RasterConfig):
    """Pixel centre coordinates within a tile, flattened row-major.

    Returns (NPIX, 1) local x and y offsets (pixel centres at +0.5 would
    change the image; the reference samples at integer coords,
    codelets.cpp:362-367, so we do too).
    """
    npix = cfg.pixels_per_tile
    idx = jnp.arange(npix, dtype=jnp.int32)
    lx = (idx % cfg.tile_width).astype(jnp.float32)
    ly = (idx // cfg.tile_width).astype(jnp.float32)
    return lx[:, None], ly[:, None]


def rasterize_tiles_jnp(binned: B.BinnedSplats, cfg: RasterConfig,
                        tile_offset=None):
    """Rasterize tiles: returns (T_local, NPIX, 4) RGBA tile buffers.

    tile_offset: global flat tile id of binned.tile_starts[0] (traced ok);
    None renders the full grid from tile 0.

    vmapped over tiles; per tile a lax.scan over up to max_chunks_per_tile
    chunks of chunk_size gaussians (tail masked). Differentiable.
    """
    c = cfg.chunk_size
    # Chunk-aligned ranges guarantee idx + c never exceeds the table for any
    # chunk with live pairs; fully-dead chunks are masked by `valid`.
    feats = binned.features
    lx, ly = _pixel_coords(cfg)
    ntx = cfg.tiles_x
    npix = cfg.pixels_per_tile
    bg = jnp.asarray(cfg.background, jnp.float32)

    def render_tile(tid, start, end):
        ox = ((tid % ntx) * cfg.tile_width).astype(jnp.float32)
        oy = ((tid // ntx) * cfg.tile_height).astype(jnp.float32)
        px = lx + ox
        py = ly + oy

        # Rematerialised: without this, reverse-mode saves the (NPIX, C)
        # alpha/transmittance intermediates of every chunk of every tile
        # (hundreds of GB at 720p); with it, backward memory is just the
        # (NPIX,) carries.
        @jax.checkpoint
        def step(carry, k):
            t, color, stopped = carry
            idx = start + k * c
            chunk = jax.lax.dynamic_slice(feats, (0, idx),
                                          (B.TABLE_ROWS, c))
            valid = idx + jnp.arange(c, dtype=jnp.int32) < end
            alpha = chunk_alphas(chunk, px, py, valid, cfg)
            rgb = chunk[B.FEAT_R:B.FEAT_B + 1].T  # (C, 3)
            add, t, stopped = composite_chunk(t, stopped, alpha, rgb, cfg)
            return (t, color + add, stopped), None

        t0 = jnp.ones((npix, 1), jnp.float32)
        c0 = jnp.zeros((npix, 3), jnp.float32)
        s0 = jnp.zeros((npix, 1), jnp.bool_)
        (t, color, _), _ = jax.lax.scan(
            step, (t0, c0, s0), jnp.arange(cfg.max_chunks_per_range))
        color = color + t * bg[None, :]
        return jnp.concatenate([color, 1.0 - t], axis=-1)

    num_local = binned.tile_starts.shape[0]
    off = jnp.asarray(0 if tile_offset is None else tile_offset, jnp.int32)
    tids = off + jnp.arange(num_local, dtype=jnp.int32)
    return jax.vmap(render_tile)(tids, binned.tile_starts, binned.tile_ends)
