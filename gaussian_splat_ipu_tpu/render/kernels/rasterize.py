"""Rasterize kernels (Pallas, Triton route): per-pixel tile compositing.

The role of the reference's fused GSplat vertex
(codelets/splat/codelets.cpp:143-641), as one program per framebuffer tile:

  * the tile's pixels are one block; each pixel keeps its state in
    registers (transmittance, the three colour sums, the position of its
    terminating pair);
  * the tile's depth-sorted range is walked front to back one pair at a
    time, the pair's features broadcast to every pixel: the reference's
    per-pixel loop (codelets.cpp:362-412), with its exact skip and break
    rules (power > 0 or alpha < 1/255 skip; a pair whose blend would take T
    below 1e-4 stops the pixel before it is blended, codelets.cpp:389-411);
  * the walk is bounded by ``max_chunks_per_range * chunk_size`` pairs,
    like the jnp spec (render/tile_raster.py), and the whole tile exits
    as soon as every pixel has stopped, so the work per tile follows its
    own occupancy, not the longest range in the frame.

The backward replays each pixel back to front from its final transmittance
and contributor count (both saved by the forward), so its memory is
O(pixels), not O(pixels * pairs). Per-pair gradients are summed over the
tile's pixels; with ``tile_group == 1`` every pair belongs to one tile and
is stored once, with ``tile_group > 1`` the member tiles of a group share
the range and add into a zeroed buffer atomically.

Which build runs (compiled or interpreted) is chosen per platform in
``render/kernels/__init__.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from gaussian_splat_ipu_tpu.render import binning as B
from gaussian_splat_ipu_tpu.render.kernels import interpret_for
from gaussian_splat_ipu_tpu.utils.config import RasterConfig

# Pairs composited between two tile-wide "has every pixel stopped?" tests
# (each test is a reduction across the block).
EXIT_TEST_EVERY = 16
NUM_WARPS = 4
_RUNNING = int(jnp.iinfo(jnp.int32).max)  # stop position of a live pixel


def _tile_geometry(starts_ref, ends_ref, off_ref, cfg: RasterConfig,
                   npix_p: int):
    """This program's tile: range [start, end), pixel coordinates, and the
    mask of real pixels (the block is padded to a power of two)."""
    lid = pl.program_id(0)
    tid = off_ref[0] + lid
    start = starts_ref[lid]
    end = jnp.minimum(ends_ref[lid],
                      start + cfg.max_chunks_per_range * cfg.chunk_size)
    idx = jax.lax.broadcasted_iota(jnp.int32, (npix_p,), 0)
    ox = jax.lax.rem(tid, cfg.tiles_x) * cfg.tile_width
    oy = jax.lax.div(tid, cfg.tiles_x) * cfg.tile_height
    px = (jax.lax.rem(idx, cfg.tile_width) + ox).astype(jnp.float32)
    py = (jax.lax.div(idx, cfg.tile_width) + oy).astype(jnp.float32)
    return lid, start, end, px, py, idx < cfg.pixels_per_tile


def _pair(feat_ref, i, end, px, py, cfg: RasterConfig):
    """Features of pair i and its per-pixel alpha with the skip rules
    applied; a pair at or past `end` gets zero alpha (its row index is
    clamped into the table, so the loads stay in bounds).

    Returns (feature scalars, dx, dy, unclamped alpha, alpha)."""
    row = jnp.minimum(i, feat_ref.shape[1] - 1)
    f = [feat_ref[k, row] for k in range(B.NUM_FEATURES)]
    dx = f[B.FEAT_X] - px
    dy = f[B.FEAT_Y] - py
    power = (-0.5 * (f[B.FEAT_CONIC_A] * dx * dx
                     + f[B.FEAT_CONIC_C] * dy * dy)
             - f[B.FEAT_CONIC_B] * dx * dy)
    a_raw = f[B.FEAT_OPACITY] * jnp.exp(power)
    alpha = jnp.minimum(cfg.alpha_clamp, a_raw)
    skip = (power > 0.0) | (alpha < cfg.alpha_min) | (i >= end)
    return f, dx, dy, a_raw, jnp.where(skip, 0.0, alpha)


def _fwd_kernel(starts_ref, ends_ref, off_ref, feat_ref, out_ref, aux_ref, *,
                cfg: RasterConfig, npix_p: int):
    lid, start, end, px, py, real = _tile_geometry(
        starts_ref, ends_ref, off_ref, cfg, npix_p)
    eps = cfg.transmittance_eps

    def step(i, carry):
        t, color, stop = carry
        f, *_, alpha = _pair(feat_ref, i, end, px, py, cfg)
        test_t = t * (1.0 - alpha)
        running = stop == _RUNNING
        trig = running & (alpha > 0.0) & (test_t < eps)
        live = running & jnp.logical_not(trig)
        w = jnp.where(live, alpha * t, 0.0)
        color = tuple(c + w * f[k] for c, k in
                      zip(color, (B.FEAT_R, B.FEAT_G, B.FEAT_B)))
        return jnp.where(live, test_t, t), color, jnp.where(trig, i, stop)

    def batch(carry):
        i, st = carry
        st = jax.lax.fori_loop(0, EXIT_TEST_EVERY,
                               lambda k, s: step(i + k, s), st)
        return i + EXIT_TEST_EVERY, st

    def cond(carry):
        i, (_, _, stop) = carry
        return (i < end) & (jnp.max(stop) == _RUNNING)

    zeros = jnp.zeros((npix_p,), jnp.float32)
    state = (jnp.ones((npix_p,), jnp.float32), (zeros, zeros, zeros),
             jnp.where(real, _RUNNING, start))
    _, (t, color, stop) = jax.lax.while_loop(cond, batch, (start, state))
    for ch in range(3):
        out_ref[lid, ch, :] = color[ch] + t * cfg.background[ch]
    out_ref[lid, 3, :] = 1.0 - t
    # For the backward: the contributor count, pairs from `start` before the
    # terminating one (the break comes before the blend; f32 is exact below
    # 2^24 pairs), and the final T itself. T rebuilt as 1 - alpha would
    # lose its low bits: near the 1e-4 stop, one ulp of alpha is ~6e-4 of T,
    # and every replayed T_i of the pixel would carry that error.
    aux_ref[lid, 0, :] = (jnp.minimum(stop, end) - start).astype(jnp.float32)
    aux_ref[lid, 1, :] = t


def _bwd_kernel(starts_ref, ends_ref, off_ref, feat_ref, gout_ref, aux_ref,
                dinit_ref, dfeat_ref, *, cfg: RasterConfig, npix_p: int):
    """Per-pair feature gradients, replayed back to front.

    T before pair i is T after it divided by (1 - a_i), starting from the
    saved final T; only pairs before a pixel's terminating pair are live
    for it. dL/da_i = T_i (c_i . u) - (S_i + gT T_n) / (1 - a_i), where S_i
    sums a_j T_j (c_j . u) over the live pairs behind i and gT is the
    cotangent of the final T (background colour and alpha channel)."""
    del dinit_ref  # aliased to dfeat_ref: the zeroed gradient buffer
    lid, start, end, px, py, _ = _tile_geometry(
        starts_ref, ends_ref, off_ref, cfg, npix_p)
    # Pairs past the furthest contributor of every pixel got no weight in
    # the forward and have zero gradients: the replay starts there.
    live_end = start + aux_ref[lid, 0, :].astype(jnp.int32)
    end = jnp.minimum(end, jnp.max(live_end))
    u = [gout_ref[lid, ch, :] for ch in range(3)]
    bg = cfg.background
    t_n = aux_ref[lid, 1, :]
    g_tn = (bg[0] * u[0] + bg[1] * u[1] + bg[2] * u[2]
            - gout_ref[lid, 3, :]) * t_n
    rows = jax.lax.broadcasted_iota(jnp.int32, (B.TABLE_ROWS,), 0)

    def step(j, carry):
        t, s = carry
        i = end - 1 - j
        f, dx, dy, a_raw, alpha = _pair(feat_ref, i, end, px, py, cfg)
        a = jnp.where(i < live_end, alpha, 0.0)
        one_minus = 1.0 - a
        t_i = t / one_minus
        cu = f[B.FEAT_R] * u[0] + f[B.FEAT_G] * u[1] + f[B.FEAT_B] * u[2]
        w = a * t_i
        d_alpha = jnp.where(a > 0.0, t_i * cu - (s + g_tn) / one_minus, 0.0)
        dpow = jnp.where(a_raw < cfg.alpha_clamp, d_alpha * a, 0.0)
        m1 = jnp.sum(dpow)
        sdx = jnp.sum(dpow * dx)
        sdy = jnp.sum(dpow * dy)
        ca, cb, cc = (f[B.FEAT_CONIC_A], f[B.FEAT_CONIC_B],
                      f[B.FEAT_CONIC_C])
        grads = {
            B.FEAT_X: -(ca * sdx + cb * sdy),
            B.FEAT_Y: -(cc * sdy + cb * sdx),
            B.FEAT_CONIC_A: -0.5 * jnp.sum(dpow * dx * dx),
            B.FEAT_CONIC_B: -jnp.sum(dpow * dx * dy),
            B.FEAT_CONIC_C: -0.5 * jnp.sum(dpow * dy * dy),
            B.FEAT_R: jnp.sum(w * u[0]),
            B.FEAT_G: jnp.sum(w * u[1]),
            B.FEAT_B: jnp.sum(w * u[2]),
            B.FEAT_OPACITY: m1 / jnp.maximum(f[B.FEAT_OPACITY],
                                             cfg.alpha_min),
        }
        grow = jnp.zeros((B.TABLE_ROWS,), jnp.float32)
        for k, v in grads.items():
            grow = jnp.where(rows == k, v, grow)
        if cfg.tile_group > 1:
            # The g^2 member tiles of a group replay the same range.
            plt.atomic_add(dfeat_ref, (slice(None), i), grow)
        else:
            dfeat_ref[:, i] = grow
        return t_i, s + w * cu

    jax.lax.fori_loop(0, end - start, step,
                      (t_n, jnp.zeros((npix_p,), jnp.float32)))


def _pad_pixels(x, npix_p: int):
    """Pad the pixel (last) axis of a (T, C, NPIX) array to npix_p."""
    pad = npix_p - x.shape[-1]
    return x if pad == 0 else jnp.pad(x, ((0, 0), (0, 0), (0, pad)))


def _params():
    return dict(backend="triton",
                compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                                   num_stages=1))


def _forward(features, starts, ends, offset, cfg: RasterConfig,
             interpret: bool):
    """(T_local, 4, NPIX) RGBA tiles and the backward's (T_local, 2,
    npix_p) per-pixel contributor counts and final T."""
    npix = cfg.pixels_per_tile
    npix_p = pl.next_power_of_2(npix)
    num_tiles = starts.shape[0]
    kernel = functools.partial(_fwd_kernel, cfg=cfg, npix_p=npix_p)
    tiles, aux = pl.pallas_call(
        kernel,
        grid=(num_tiles,),
        out_shape=[
            jax.ShapeDtypeStruct((num_tiles, 4, npix_p), jnp.float32),
            jax.ShapeDtypeStruct((num_tiles, 2, npix_p), jnp.float32),
        ],
        interpret=interpret,
        name="rasterize_fwd",
        **_params(),
    )(starts, ends, offset, features)
    return tiles[..., :npix], aux


def _backward(features, starts, ends, offset, gout, aux,
              cfg: RasterConfig, interpret: bool):
    npix_p = pl.next_power_of_2(cfg.pixels_per_tile)
    kernel = functools.partial(_bwd_kernel, cfg=cfg, npix_p=npix_p)
    return pl.pallas_call(
        kernel,
        grid=(starts.shape[0],),
        out_shape=jax.ShapeDtypeStruct(features.shape, jnp.float32),
        input_output_aliases={6: 0},  # dfeat starts as the zeros input
        interpret=interpret,
        name="rasterize_bwd",
        **_params(),
    )(starts, ends, offset, features, _pad_pixels(gout, npix_p), aux,
      jnp.zeros_like(features))


def rasterize_tiles(binned: B.BinnedSplats, cfg: RasterConfig,
                    platform: str | None = None,
                    tile_offset=None) -> jnp.ndarray:
    """Rasterize binned splats -> (T_local, NPIX, 4) RGBA tile buffers.

    platform: "gpu" or "cpu" (see render/kernels/__init__.py); None takes
    the process's default backend.
    tile_offset: global flat tile id of binned.tile_starts[0] (traced scalar
    ok) — the distributed path renders a strip of tiles per device; the
    single-device path leaves it None (= 0, all tiles).

    Forward and backward are both kernels (jax.custom_vjp); the jnp
    formulation (render/tile_raster.py) is the spec both are tested
    against. The forward also keeps per-pixel contributor counts and the
    final transmittance, from which the backward rebuilds
    every intermediate in reverse order with O(pixels) memory.
    """
    interpret = interpret_for(platform)
    offset = jnp.asarray(0 if tile_offset is None else tile_offset,
                         jnp.int32).reshape((1,))

    @jax.custom_vjp
    def raster(features, starts, ends, offset):
        tiles, _ = _forward(features, starts, ends, offset, cfg, interpret)
        return tiles.transpose(0, 2, 1)  # (T_local, NPIX, 4)

    def raster_fwd(features, starts, ends, offset):
        tiles, aux = _forward(features, starts, ends, offset, cfg, interpret)
        return tiles.transpose(0, 2, 1), (features, starts, ends, offset,
                                          aux)

    def raster_bwd(res, g):
        features, starts, ends, offset, aux = res
        gout = g.transpose(0, 2, 1)  # (T_local, 4, NPIX)
        df = _backward(features, starts, ends, offset, gout, aux, cfg,
                       interpret)
        return df, None, None, None

    raster.defvjp(raster_fwd, raster_bwd)
    return raster(binned.features, binned.tile_starts, binned.tile_ends,
                  offset)
