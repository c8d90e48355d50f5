"""Gaussian -> tile binning: the replacement for the reference's exchange
lattice.

The reference migrates gaussians between neighbouring IPU tiles one hop per
frame over fixed 300-slot channels with greedy Manhattan routing and a beam
protocol for multi-tile footprints (src/splat/edge_builder.cpp:35-84,
codelets/splat/codelets.cpp:194-293,554-572) — the image only converges
over several frames. Here binning is exact, every frame:

  1. per-gaussian tile-coverage rectangle from the 3-sigma radius
     (the Bounds2f::clip / direction logic of ipu_geometry.hpp:133-155
     becomes a clamped tile-range computation),
  2. expand to (gaussian, tile) pairs into a fixed-capacity table
     (static shapes; overflow is dropped and counted, the analogue of the
     reference's bounded channels + keep-local fallback,
     codelets.cpp:487-490),
  3. lexicographic sort by (tile, depth) — the packed sort-key idea of the
     reference's unused CullGaussians vertex (codelets.cpp:104-113),
  4. CSR-style per-tile [start, end) ranges via searchsorted.

Everything is static-shaped and jit-compatible; the sort runs on-device.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussian_splat_ipu_tpu.render.projection import ProjectedSplats
from gaussian_splat_ipu_tpu.utils.config import RasterConfig

# Rows of the feature-major (TABLE_ROWS, P) pair table handed to the
# rasterizer. Feature-major: each feature row is contiguous along the pairs,
# so the kernel's per-pair reads walk consecutive addresses of 10 rows, and
# the jnp spec slices (TABLE_ROWS, C) chunks. Only the NUM_FEATURES live
# rows ride the sort; rows [NUM_FEATURES, TABLE_ROWS) are a zero block
# appended afterwards, which keeps a gradient row a power of two long.
FEAT_X = 0
FEAT_Y = 1
FEAT_CONIC_A = 2
FEAT_CONIC_B = 3
FEAT_CONIC_C = 4
FEAT_R = 5
FEAT_G = 6
FEAT_B = 7
FEAT_OPACITY = 8
FEAT_DEPTH = 9
NUM_FEATURES = 10
TABLE_ROWS = 16


class BinnedSplats(NamedTuple):
    """Sorted (gaussian, tile) pair table + per-tile ranges.

    Tile t's pairs occupy [tile_starts[t], tile_ends[t]) in the feature
    table, depth-ascending. The capacity P is a multiple of the chunk
    size, so the jnp spec's chunk slices stay in bounds.
    """

    features: jnp.ndarray    # (TABLE_ROWS, P) f32, sorted (tile, depth)
    pair_gid: jnp.ndarray    # (P,) i32 gaussian index per pair (N for pad)
    tile_starts: jnp.ndarray  # (T,) i32
    tile_ends: jnp.ndarray   # (T,) i32
    num_pairs: jnp.ndarray   # () i32 valid pairs (pre-truncation demand)
    overflow: jnp.ndarray    # () i32 pairs dropped due to capacity


def tile_ranges_of(splats: ProjectedSplats, cfg: RasterConfig,
                   row_lo=0, row_hi=None):
    """Clamped tile-rectangle [x0, y0] + [nx, ny] per gaussian.

    row_lo/row_hi restrict coverage to tile rows [row_lo, row_hi) — the
    distributed path passes this device's row strip (traced scalars are
    fine) so only locally-owned (gaussian, tile) pairs are ever enumerated.
    A gaussian disjoint from the strip gets nx = ny = 0.
    """
    ntx, nty = cfg.tiles_x, cfg.tiles_y
    if row_hi is None:
        row_hi = nty
    rx, ry = splats.radius[:, 0], splats.radius[:, 1]
    visible = rx > 0.0
    x, y = splats.xy[:, 0], splats.xy[:, 1]

    def span(c, r, tile_sz, lo_bound, hi_bound):
        lo = jnp.maximum(jnp.floor((c - r) / tile_sz).astype(jnp.int32),
                         lo_bound)
        hi = jnp.minimum(jnp.floor((c + r) / tile_sz).astype(jnp.int32),
                         hi_bound - 1)
        n = jnp.maximum(hi - lo + 1, 0)  # 0 when disjoint from the bounds
        # Footprint guard band (reference clipSize, codelets.cpp:622,470).
        return lo, jnp.clip(n, 0, cfg.max_tiles_per_axis)

    x0, nx = span(x, rx, cfg.tile_width, 0, ntx)
    y0, ny = span(y, ry, cfg.tile_height, row_lo, row_hi)
    nx = jnp.where(visible, nx, 0)
    ny = jnp.where(visible, ny, 0)
    return x0, y0, nx, ny


MASK_SPAN = 8  # tile window of the 64-bit exact-coverage mask (8x8)


def _coverage_masks(splats: ProjectedSplats, cfg: RasterConfig,
                    x0, y0, nx, ny, cell_w=None, cell_h=None):
    """Per-gaussian EXACT cell-coverage bitmask over an 8x8 cell window.

    A "cell" is one tile (per-tile binning) or one tile GROUP (tile_group
    binning — the caller passes cell_w/cell_h = g * tile size and
    group-space x0/y0/nx/ny; the same closed-form edge minimisation works
    on the g-times-larger pixel rectangle, so the two pair-cutting levers
    COMPOSE). Bit k (k = dy*8 + dx) is set iff cell (x0+dx, y0+dy)
    contains a pixel that can clear alpha_min for this splat: the minimum
    over the cell's pixel rectangle of the conic quadratic F(u, v) =
    A u^2 + 2B u v + C v^2 (the kernel evaluates power = -F/2,
    tile_raster.chunk_alphas) is <= q = 2 ln(opacity / alpha_min). For a
    positive-definite F whose unconstrained minimum (the splat centre)
    lies outside the rectangle, the constrained minimum lies on one of
    the four edges; each edge is a 1D quadratic minimised in closed form
    with clamping. Pixels sample at integer coordinates
    (tile_raster._pixel_coords), so cell cx spans
    u in [cx*cw - gx, cx*cw + cw - 1 - gx]. (Partial cells at the image
    border test a superset of their real pixels — conservative: a cell is
    only ever kept extra, never dropped.)

    Only footprints with nx, ny <= 8 cells are testable (bigger ones keep
    their whole rectangle — they are rare and the mask would not fit).

    Returns (testable (N,) bool, mlo, mhi (N,) i32 mask words, ncov_exact
    (N,) i32 popcount). Everything is gradient-free (binning geometry).
    """
    sg = jax.lax.stop_gradient
    gx, gy = sg(splats.xy[:, 0]), sg(splats.xy[:, 1])
    ca, cb, cc = (sg(splats.conic[:, 0]), sg(splats.conic[:, 1]),
                  sg(splats.conic[:, 2]))
    op = sg(splats.opacity)
    q = 2.0 * jnp.log(jnp.maximum(op, 1e-12) / cfg.alpha_min)
    # Slack: a cell whose best pixel sits exactly at alpha_min must stay
    # (the kernel's skip is a strict <) even across fp rounding paths.
    q = q * (1.0 + 1e-4) + 1e-4
    tw = float(cell_w if cell_w is not None else cfg.tile_width)
    th = float(cell_h if cell_h is not None else cfg.tile_height)
    testable = (nx <= MASK_SPAN) & (ny <= MASK_SPAN) & (nx * ny > 0)
    ca_s = jnp.maximum(ca, 1e-12)
    cc_s = jnp.maximum(cc, 1e-12)
    x0f = x0.astype(jnp.float32)
    y0f = y0.astype(jnp.float32)

    def edge_u(e, v0, v1):
        v = jnp.clip(-cb * e / cc_s, v0, v1)
        return ca * e * e + 2.0 * cb * e * v + cc * v * v

    def edge_v(f, u0, u1):
        u = jnp.clip(-cb * f / ca_s, u0, u1)
        return ca * u * u + 2.0 * cb * u * f + cc * f * f

    def body(k, carry):
        mlo, mhi, count = carry
        dx = (k & 7).astype(jnp.float32)
        dy = (k >> 3).astype(jnp.float32)
        u0 = (x0f + dx) * tw - gx
        u1 = u0 + (tw - 1.0)
        v0 = (y0f + dy) * th - gy
        v1 = v0 + (th - 1.0)
        inside = (u0 <= 0.0) & (0.0 <= u1) & (v0 <= 0.0) & (0.0 <= v1)
        fmin = jnp.minimum(
            jnp.minimum(edge_u(u0, v0, v1), edge_u(u1, v0, v1)),
            jnp.minimum(edge_v(v0, u0, u1), edge_v(v1, u0, u1)))
        fmin = jnp.where(inside, 0.0, fmin)
        in_rect = (dx < nx.astype(jnp.float32)) & (
            dy < ny.astype(jnp.float32))
        keep = testable & in_rect & (fmin <= q)
        bit = jnp.where(keep, jnp.int32(1) << (k & 31), 0)
        is_lo = k < 32
        mlo = mlo | jnp.where(is_lo, bit, 0)
        mhi = mhi | jnp.where(is_lo, 0, bit)
        return mlo, mhi, count + keep.astype(jnp.int32)

    n = gx.shape[0]
    zeros = jnp.zeros((n,), jnp.int32)
    mlo, mhi, count = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(MASK_SPAN * MASK_SPAN), body,
        (zeros, zeros, zeros))
    return testable, mlo, mhi, count


def _pair_tile_decode(geom_g, mlo_g, mhi_g, rank):
    """Per-pair rank -> (tx, ty), from the 31-bit packed geometry
    (x0 | y0<<12 | nx<<24 | masked<<30) used by the exact/presort
    fallback paths."""
    gx0 = geom_g & 0xFFF
    gy0 = (geom_g >> 12) & 0xFFF
    gnx = jnp.maximum((geom_g >> 24) & 0x3F, 1)
    masked = (geom_g >> 30) & 1
    return _decode_tiles(gx0, gy0, gnx, masked, mlo_g, mhi_g, rank)


def _decode_tiles(gx0, gy0, gnx, masked, mlo_g, mhi_g, rank):
    """Per-pair rank -> (tx, ty) tile coordinates.

    Unmasked: row-major walk of the coverage rectangle via a
    floor-exact f32 division (exact while quotient*divisor < 2^24).
    Masked (exact_tile_test): rank selects the rank-th SET BIT of the
    64-bit coverage mask — a 5-step binary search over popcounts of
    shrinking windows, elementwise ops only (~40/pair, no gathers).
    """
    popcount = jax.lax.population_count
    # Unmasked rectangle walk.
    ty_u = jnp.floor(rank.astype(jnp.float32)
                     / gnx.astype(jnp.float32)).astype(jnp.int32)
    tx_u = rank - ty_u * gnx
    # Masked: rank-th set bit of (mhi:mlo).
    c0 = popcount(mlo_g)
    in_hi = rank >= c0
    w = jnp.where(in_hi, mhi_g, mlo_g)
    r = rank - jnp.where(in_hi, c0, 0)
    pos = jnp.zeros_like(rank)
    for width in (16, 8, 4, 2, 1):
        window = jnp.int32((1 << width) - 1) << pos
        c = popcount(w & window)
        go = r >= c
        r = r - jnp.where(go, c, 0)
        pos = pos + jnp.where(go, width, 0)
    k = jnp.where(in_hi, 32, 0) + pos
    tx_m = k & 7
    ty_m = k >> 3
    tx = gx0 + jnp.where(masked == 1, tx_m, tx_u)
    ty = gy0 + jnp.where(masked == 1, ty_m, ty_u)
    return tx, ty


@jax.custom_vjp
def _sorted_feature_table(packed, tile, gid_pre):
    """Expansion gather + (tile, depth) radix sorts -> feature table.

    packed: (N+1, NUM_FEATURES) per-gaussian rows (row N zero, owns pads);
    tile:   (P,) destination tile per pair (pad sentinel sorts last);
    gid_pre:(P,) owning gaussian per pair, ascending (N for pads).
    Returns (feats (TABLE_ROWS, P), tile_s (P,), gid_s (P,)).

    custom_vjp because the whole block is a row-selection of `packed`:
    autodiff would transpose each sort into its own P-wide scatter
    (~10 carried columns each) before the final scatter-add. The hand
    backward is ONE scatter-add of
    the cotangent rows by the sorted gaussian id (addition commutes, so the
    sort permutation never needs inverting).
    """
    table = packed[gid_pre]                        # (P, F) ascending gather
    is_pad = gid_pre >= packed.shape[0] - 1
    # Depth bits: order-isomorphic i32 view of the (positive) depth column.
    depth_bits = jnp.where(
        is_pad, jnp.int32(0x7FFFFFFF),
        jax.lax.bitcast_convert_type(table[:, FEAT_DEPTH], jnp.int32))
    cols = [table[:, i] for i in range(NUM_FEATURES)]
    # Lexicographic (tile, depth) via two stable single-key radix passes:
    # secondary key (depth) first, then primary (tile), columns riding as
    # carried values.
    pass1 = jax.lax.sort(tuple([depth_bits, tile, gid_pre] + cols),
                         num_keys=1)
    pass2 = jax.lax.sort(tuple(pass1[1:]), num_keys=1)
    feats = jnp.concatenate(
        [jnp.stack(pass2[2:], axis=0),
         jnp.zeros((TABLE_ROWS - NUM_FEATURES, tile.shape[0]),
                   jnp.float32)], axis=0)          # (TABLE_ROWS, P)
    return feats, pass2[0], pass2[1]


def _sorted_feature_table_fwd(packed, tile, gid_pre):
    out = _sorted_feature_table(packed, tile, gid_pre)
    _, _, gid_s = out
    return out, (gid_s, packed.shape[0])


def _sorted_feature_table_bwd(res, cotangents):
    gid_s, n_rows = res
    dfeats = cotangents[0]                         # (TABLE_ROWS, P)
    rows = dfeats[:NUM_FEATURES].T                 # (P, F)
    dpacked = jnp.zeros((n_rows, NUM_FEATURES), rows.dtype)
    # Pads carry gid_s == N and their garbage/zero grads land in row N,
    # which the caller discards.
    dpacked = dpacked.at[gid_s].add(rows)
    return dpacked, None, None


_sorted_feature_table.defvjp(_sorted_feature_table_fwd,
                             _sorted_feature_table_bwd)


@jax.custom_vjp
def _fused_feature_table(packed, rank, gid_pre, depth_keep_bits, ntx_s):
    """Expansion gather + ONE stable sort on a fused (tile, depth) key.

    The sort key packs (tile, quantized depth) into one i32:
    key = (tile << depth_keep_bits) | (depth_bits >> (31 - depth_keep_bits))
    where depth_bits is the order-isomorphic i32 view of the positive f32
    depth. Ties within a depth quantum fall back to gaussian-id order
    (stable sort over the ascending pre-sort gid). depth_keep_bits/ntx_s
    are traced i32 scalars.

    packed is (N+1, 16): the 10 feature columns plus SIX exact-in-f32
    integer payload columns — xy0 = x0 | y0<<12 (24-bit), nxm = nx |
    masked<<6 (7-bit), and the four 16-bit halves of the two coverage-
    mask words (small non-negative integers encode exactly as f32). Row N
    is zero and owns the pad pairs. The expansion is the ascending row
    gather packed[gid_pre]; the destination tile of each pair is decoded
    from the expanded columns + the pair's rank (_decode_tiles), and only
    the 10 feature columns ride the sort as carried values.

    custom_vjp: the whole block is a row-selection of `packed`, so the
    backward is ONE scatter-add of the cotangent rows by the sorted
    gaussian id (see _sorted_feature_table).

    Returns (feats (TABLE_ROWS, P), tile_s (P,), gid_s (P,)).
    """
    n = packed.shape[0] - 1
    table = packed[gid_pre]                        # (P, 16) ascending gather
    is_pad = gid_pre >= n

    def col(i):
        return table[:, i].astype(jnp.int32)

    xy0 = col(NUM_FEATURES)
    nxm = col(NUM_FEATURES + 1)
    mlo_g = (col(NUM_FEATURES + 3) << 16) | col(NUM_FEATURES + 2)
    mhi_g = (col(NUM_FEATURES + 5) << 16) | col(NUM_FEATURES + 4)
    tx, ty = _decode_tiles(xy0 & 0xFFF, xy0 >> 12,
                           jnp.maximum(nxm & 0x3F, 1),
                           (nxm >> 6) & 1, mlo_g, mhi_g, rank)
    tile = ty * ntx_s + tx
    depth_bits = jax.lax.bitcast_convert_type(table[:, FEAT_DEPTH],
                                              jnp.int32)
    key = jnp.where(
        is_pad, jnp.int32(0x7FFFFFFF),
        (tile << depth_keep_bits)
        | (depth_bits >> (jnp.int32(31) - depth_keep_bits)))
    cols = [table[:, i] for i in range(NUM_FEATURES)]
    out = jax.lax.sort(tuple([key, gid_pre] + cols), num_keys=1)
    feats = jnp.concatenate(
        [jnp.stack(out[2:], axis=0),
         jnp.zeros((TABLE_ROWS - NUM_FEATURES, rank.shape[0]),
                   jnp.float32)], axis=0)          # (TABLE_ROWS, P)
    return feats, out[0] >> depth_keep_bits, out[1]


def _fused_feature_table_fwd(packed, rank, gid_pre, depth_keep_bits,
                             ntx_s):
    out = _fused_feature_table(packed, rank, gid_pre, depth_keep_bits,
                               ntx_s)
    return out, (out[2], packed.shape)


def _fused_feature_table_bwd(res, cotangents):
    gid_s, pshape = res
    rows = cotangents[0][:NUM_FEATURES].T          # (P, F)
    # Whole-row scatter-add; the integer payload columns get zeros.
    dbody = jnp.zeros((pshape[0], NUM_FEATURES), rows.dtype)
    dbody = dbody.at[gid_s].add(rows)
    dpacked = jnp.concatenate(
        [dbody, jnp.zeros((pshape[0], pshape[1] - NUM_FEATURES),
                          rows.dtype)], axis=-1)
    return dpacked, None, None, None, None


_fused_feature_table.defvjp(_fused_feature_table_fwd,
                            _fused_feature_table_bwd)


@jax.custom_vjp
def _presorted_feature_table(packed, rank, gid_pre, ntx_s):
    """Tile-only single-key sort over pairs of DEPTH-PRESORTED gaussians.

    packed: (N+1, NUM_FEATURES + 4) rows in depth order — the 10 feature
    columns, the packed coverage geometry + two mask words (as in the
    fused path), and the ORIGINAL gaussian id bitcast to f32 (so pair_gid
    can be reported in caller space without a separate (P,)-element
    gather). gid_pre indexes the DEPTH-SORTED rows,
    ascending.

    Because the pair stream is generated in depth order and the sort is
    stable, sorting by tile id alone yields (tile, depth)-sorted pairs
    with EXACT f32 depth order (the fused path quantizes depth into the
    key's spare bits). The key's value range is just the tile count — a
    microbenchmark target for radix-pass pruning vs the 31-bit fused key.

    Returns (feats (TABLE_ROWS, P), tile_s, gid_s (depth-space),
    orig_gid_s (caller-space)).
    """
    is_pad = gid_pre >= packed.shape[0] - 1
    table = packed[gid_pre]                 # (P, F+4) ascending gather
    geom_g = jax.lax.bitcast_convert_type(table[:, NUM_FEATURES],
                                          jnp.int32)
    mlo_g = jax.lax.bitcast_convert_type(table[:, NUM_FEATURES + 1],
                                         jnp.int32)
    mhi_g = jax.lax.bitcast_convert_type(table[:, NUM_FEATURES + 2],
                                         jnp.int32)
    tx, ty = _pair_tile_decode(geom_g, mlo_g, mhi_g, rank)
    key = jnp.where(is_pad, jnp.int32(0x7FFFFFFF), ty * ntx_s + tx)
    orig_gid = jax.lax.bitcast_convert_type(table[:, NUM_FEATURES + 3],
                                            jnp.int32)
    cols = [table[:, i] for i in range(NUM_FEATURES)]
    out = jax.lax.sort(tuple([key, gid_pre, orig_gid] + cols), num_keys=1)
    feats = jnp.concatenate(
        [jnp.stack(out[3:], axis=0),
         jnp.zeros((TABLE_ROWS - NUM_FEATURES, rank.shape[0]),
                   jnp.float32)], axis=0)
    return feats, out[0], out[1], out[2]


def _presorted_feature_table_fwd(packed, rank, gid_pre, ntx_s):
    out = _presorted_feature_table(packed, rank, gid_pre, ntx_s)
    return out, (out[2], packed.shape[0])


def _presorted_feature_table_bwd(res, cotangents):
    gid_s, n_rows = res
    rows = cotangents[0][:NUM_FEATURES].T
    dbody = jnp.zeros((n_rows, NUM_FEATURES), rows.dtype)
    dbody = dbody.at[gid_s].add(rows)
    dpacked = jnp.concatenate(
        [dbody, jnp.zeros((n_rows, 4), rows.dtype)], axis=-1)
    return dpacked, None, None, None


_presorted_feature_table.defvjp(_presorted_feature_table_fwd,
                                _presorted_feature_table_bwd)


def expand_pairs(ncov: jnp.ndarray, p: int):
    """Expand per-gaussian pair counts (N,) into a P-slot pair table.

    Scatters each gaussian's id at its first slot and forward-fills with
    cummax, then derives each pair's rank within its gaussian's run from
    the id transitions with one more cummax. A sentinel gaussian N owns
    the pad tail. Returns (gid (P,), rank (P,), total demand ())."""
    n = ncov.shape[0]
    ncov_ext = jnp.concatenate([ncov, jnp.array([p], jnp.int32)])
    ends_cum = jnp.cumsum(ncov_ext)
    offsets_ext = ends_cum - ncov_ext          # exclusive
    total = ends_cum[-2] if n else jnp.int32(0)
    first_slot = jnp.where(ncov_ext > 0, offsets_ext, p)  # no empties
    iota_n = jnp.arange(n + 1, dtype=jnp.int32)
    gid_at = jnp.zeros((p,), jnp.int32).at[first_slot].max(
        iota_n, mode="drop")
    gid = jax.lax.cummax(gid_at)
    slot = jnp.arange(p, dtype=jnp.int32)
    prev_gid = jnp.concatenate([jnp.full((1,), -1, jnp.int32), gid[:-1]])
    rank = slot - jax.lax.cummax(jnp.where(gid != prev_gid, slot, 0))
    return gid, rank, total


def bin_splats(splats: ProjectedSplats, cfg: RasterConfig,
               row_lo=None, num_rows: int | None = None,
               pair_capacity: int | None = None) -> BinnedSplats:
    """Bin splats into per-tile depth-sorted ranges.

    With row_lo/num_rows set, bins only tiles in rows
    [row_lo, row_lo + num_rows) — this device's strip in the distributed
    renderer — and tile_starts/ends cover just those num_rows*tiles_x tiles
    (still indexed by GLOBAL flat tile id in the sort keys). row_lo may be a
    traced scalar (e.g. axis_index inside shard_map); num_rows and
    pair_capacity must be static.
    """
    n = splats.xy.shape[0]
    p = pair_capacity or cfg.pair_capacity
    ntx = cfg.tiles_x
    num_tiles = cfg.num_tiles
    g = cfg.tile_group
    # Tile-group binning (see RasterConfig.tile_group): pairs are keyed
    # by super-tile; composes with exact_tile_test (the coverage mask is
    # evaluated over GROUP cells below). Row strips need NOT align to
    # group rows: a group row straddling two devices is binned by both
    # (each from its own clamped tile-row view), and per-pixel coverage
    # tests make superset pair lists harmless — the only cost is the
    # duplicated boundary-group pairs. The distributed callers
    # group-align their strips (_rows_per_device) so none are
    # duplicated in practice (VERDICT r4 #5).
    if row_lo is None:
        row_lo = 0
        num_rows = cfg.tiles_y
    assert num_rows is not None
    # Packed-geometry bit budget (x0:12, y0:12, nx:6, masked-flag:1) and
    # the float-division floor proof below both need bounded footprints.
    assert cfg.max_tiles_per_axis <= 32 and cfg.tiles_x <= 4096 \
        and cfg.tiles_y <= 4096
    num_local = num_rows * ntx
    row_lo = jnp.asarray(row_lo, jnp.int32)
    # Uneven row sharding leaves phantom rows past the grid on the last
    # device; clamp so no pairs are ever generated for them.
    row_hi = jnp.minimum(row_lo + num_rows, cfg.tiles_y)

    x0, y0, nx, ny = tile_ranges_of(splats, cfg, row_lo, row_hi)
    if g > 1:
        # Convert footprints to GROUP units: a k-tile span inside one
        # group collapses to one pair. All downstream geometry (geom
        # packing, rank decode, sort keys, CSR queries) then runs in
        # group space; per-TILE ranges are recovered at the end by
        # pointing every member tile at its group's range.
        x1 = x0 + jnp.maximum(nx - 1, 0)
        y1 = y0 + jnp.maximum(ny - 1, 0)
        gx0, gy0 = x0 // g, y0 // g
        nx = jnp.where(nx > 0, x1 // g - gx0 + 1, 0)
        ny = jnp.where(ny > 0, y1 // g - gy0 + 1, 0)
        x0, y0 = gx0, gy0
        ntx_key = -(-cfg.tiles_x // g)           # groups across
        num_keys_total = ntx_key * (-(-cfg.tiles_y // g))
        # Group-row analogue of the tile-space phantom-row slack below:
        # uneven sharding can query group rows past the grid. The bound
        # uses the GLOBAL grid height, not this strip's num_rows (which
        # it dominates), so tile_bits — and hence the fused key's depth
        # quantization — is IDENTICAL across device counts: a sharded
        # render is bit-identical to the single-device one.
        max_query_key = 2 * (-(-cfg.tiles_y // g)) * ntx_key
    else:
        ntx_key = ntx
        num_keys_total = num_tiles
        max_query_key = None
    ncov = (nx * ny).astype(jnp.int32)
    if cfg.exact_tile_test:
        # Exact per-cell coverage: only tiles (groups, when g > 1 —
        # x0/y0/nx/ny are already in group space and the cell rectangle
        # scales by g) whose pixel rect can clear alpha_min are
        # enumerated (the ellipse misses many corner cells of the
        # bounding rectangle). Output is pixel-identical; every O(P)
        # binning pass and the per-tile compositing shrink.
        testable, mlo, mhi, ncov_x = _coverage_masks(
            splats, cfg, x0, y0, nx, ny,
            cell_w=g * cfg.tile_width, cell_h=g * cfg.tile_height)
        ncov = jnp.where(testable, ncov_x, ncov).astype(jnp.int32)
        flag = jnp.where(testable, jnp.int32(1) << 30, 0)
    else:
        mlo = mhi = flag = jnp.zeros_like(ncov)

    # Packed per-gaussian coverage geometry: x0/y0 need <=12 bits each
    # (4096-tile axes), nx 6 bits, exact-mask flag at bit 30. It rides
    # the one per-pair row gather instead of a separate (P,) gather.
    geom = jnp.where(ncov > 0, x0 | (y0 << 12) | (nx << 24) | flag, 0)
    body = jnp.concatenate([
        splats.xy, splats.conic, splats.color,
        splats.opacity[:, None], splats.depth[:, None],
    ], axis=-1)                                   # (N, 10)

    # Global-grid bound (not num_rows) for the same bit-consistency
    # reason as max_query_key above.
    max_query_tid = (max_query_key if g > 1
                     else 2 * cfg.tiles_y * ntx)
    tile_bits = (max_query_tid + 1).bit_length()
    use_presort = (cfg.presort_depth and cfg.fused_sort_key
                   and tile_bits <= 31 and n > 0)
    perm = None
    if use_presort:
        # Depth-presort the GAUSSIANS (N elements, not P pairs): the pair
        # stream below then comes out in depth order and the P-wide sort
        # needs only the small-range tile key; stability does the rest.
        depth_key = jax.lax.bitcast_convert_type(
            jax.lax.stop_gradient(splats.depth).astype(jnp.float32),
            jnp.int32)
        # Culled gaussians (ncov == 0) generate no pairs; force them last
        # anyway so negative-depth bit patterns cannot interleave.
        depth_key = jnp.where(ncov > 0, depth_key, jnp.int32(0x7FFFFFFF))
        _, perm = jax.lax.sort(
            (depth_key, jnp.arange(n, dtype=jnp.int32)), num_keys=1)
        body = body[perm]
        geom = geom[perm]
        mlo = mlo[perm]
        mhi = mhi[perm]
        ncov = ncov[perm]

    gid, rank, total = expand_pairs(ncov, p)
    is_pad = gid >= n

    # Per-gaussian packed rows; row N stays zero for pad pairs, so padding
    # renders as alpha=0 and a garbage-free conic. Expanded to the pair
    # table BEFORE the sort: pre-sort gid is ascending, so this gather is
    # sequential, and the columns then ride the sort as carried values.
    assert p % cfg.chunk_size == 0, "pair_capacity must be chunk-aligned"
    gid_pre = jnp.where(is_pad, n, gid)
    # Sort-path selection. Fused: single (tile | quantized-depth) i32 key
    # when the tile id and a useful depth share an i32 (>=16 depth bits).
    # Presort: gaussians already depth-ordered above, tile-only key.
    # Exact: two-pass (tile, full depth) fallback/debug path.
    # The pad sentinel recovers as the all-ones tile id (2^tile_bits - 1),
    # so the bit budget must cover the largest tile id the CSR queries —
    # on the last device of an uneven row sharding that includes PHANTOM
    # rows past the grid (up to row_lo + num_rows - 1), not just
    # num_tiles - 1; otherwise pads collide with a phantom tile and its
    # range spans the whole pad tail.
    def i32col(x):
        return jax.lax.bitcast_convert_type(x, jnp.float32)[:, None]

    if use_presort:
        packed = jnp.concatenate(
            [jnp.concatenate(
                [body, i32col(geom), i32col(mlo), i32col(mhi),
                 i32col(perm)], axis=-1),
             jnp.concatenate(
                 [jnp.zeros((1, NUM_FEATURES + 3), jnp.float32),
                  jax.lax.bitcast_convert_type(
                      jnp.full((1, 1), n, jnp.int32), jnp.float32)],
                 axis=-1)])
        feats, tile_s, _, gid_s = _presorted_feature_table(
            packed, rank, gid_pre, jnp.int32(ntx_key))
    elif cfg.fused_sort_key and 31 - tile_bits >= 16:
        # 16-column packed layout for the fused path: integer payloads as
        # exact-in-f32 pieces (small non-negative ints encode exactly).
        flag01 = flag >> 30
        live = ncov > 0

        def f24(v):
            return jnp.where(live, v, 0).astype(jnp.float32)

        intcols = jnp.stack([
            f24(x0 | (y0 << 12)),
            f24(nx | (flag01 << 6)),
            f24(mlo & 0xFFFF), f24((mlo >> 16) & 0xFFFF),
            f24(mhi & 0xFFFF), f24((mhi >> 16) & 0xFFFF)], axis=-1)
        packed = jnp.concatenate(
            [jnp.concatenate([body, intcols], axis=-1),
             jnp.zeros((1, NUM_FEATURES + 6), jnp.float32)])
        feats, tile_s, gid_s = _fused_feature_table(
            packed, rank, gid_pre, jnp.int32(31 - tile_bits),
            jnp.int32(ntx_key))
    else:
        # Exact path computes the destination tile here (extra (P,)
        # geometry gathers; this is the debug/fallback path).
        gidc = jnp.minimum(gid, n - 1)
        tx, ty = _pair_tile_decode(geom[gidc], mlo[gidc], mhi[gidc], rank)
        # Pad sentinel sorts after every real (and phantom-row) tile id.
        tile = jnp.where(is_pad, jnp.int32(1 << 30), ty * ntx_key + tx)
        packed = jnp.concatenate(
            [body, jnp.zeros((1, NUM_FEATURES), jnp.float32)])
        feats, tile_s, gid_s = _sorted_feature_table(packed, tile, gid_pre)
    pad_s = tile_s >= num_keys_total

    # Per-tile global ids this call reports ranges for.
    if g > 1:
        # Every member tile of a group points at the group's range
        # (rows offset by this device's strip start).
        rows_t = row_lo + jnp.arange(num_local, dtype=jnp.int32) // ntx
        cols_t = jnp.arange(num_local, dtype=jnp.int32) % ntx
        tids = (rows_t // g) * ntx_key + cols_t // g
    else:
        tids = row_lo * ntx + jnp.arange(num_local, dtype=jnp.int32)
    return BinnedSplats(
        features=feats,
        pair_gid=jnp.where(pad_s, n, gid_s).astype(jnp.int32),
        tile_starts=jnp.searchsorted(tile_s, tids,
                                     side="left").astype(jnp.int32),
        tile_ends=jnp.searchsorted(tile_s, tids,
                                   side="right").astype(jnp.int32),
        num_pairs=jnp.minimum(total, p),
        overflow=jnp.maximum(total - p, 0),
    )
