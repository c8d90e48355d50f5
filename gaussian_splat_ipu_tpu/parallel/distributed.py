"""Distributed rendering + training over a device mesh (shard_map).

The replacement for the reference's tile-exchange scaling story
(SURVEY.md §2: framebuffer sharded one region per IPU tile, gaussians sliced
across the same tiles, neighbour-lattice migration one hop per frame —
src/splat/ipu_rasteriser.cpp:164-214, src/splat/edge_builder.cpp:35-84).

Design — one mesh axis, two roles:

  1. *Projection is data-parallel over gaussians.* Each device holds an N/D
     shard of the parameter pytree and projects it locally.
  2. *Exchange is a per-destination all_to_all of compact projected splats*
     (12 f32 per gaussian — position/depth/conic/color/opacity/radius), NOT
     of raw parameters (59+ floats incl. SH): each device routes every
     locally-projected splat only to the device(s) whose framebuffer row
     strip its footprint touches, through fixed-capacity per-destination
     buckets with counted overflow (the bounded-channel discipline of the
     reference's exchange lattice, src/splat/edge_builder.cpp:35-84). Per-
     device interconnect traffic and post-exchange live memory scale with the
     strip-crossing splat population — NOT with global N, as the previous
     all_gather design did. The autodiff transpose of the routing gather +
     all_to_all is the reverse all_to_all + a scatter-add, so splat
     gradients land back on the owning shard with no separate all-reduce.
     (`exchange="all_gather"` keeps the old replicate-everything path for
     comparison and for tiny meshes.)
  3. *Rasterization is spatially parallel over framebuffer tile rows.* Each
     device bins ONLY its own row strip (render/binning.py row_lo/num_rows:
     pairs for other devices' tiles are never enumerated) and rasterizes it
     with the rasterizer kernel; the image comes back tile-row-sharded.

Every frame is exact — no multi-frame migration transient like the
reference's lattice (SURVEY.md §3.2 note).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu.parallel.mesh import SHARD_AXIS, VIEW_AXIS
from gaussian_splat_ipu_tpu.render import binning, pipeline, tile_raster
from gaussian_splat_ipu_tpu.render.projection import (ProjectedSplats,
                                                      project_gaussians)
from gaussian_splat_ipu_tpu.train import losses as loss_lib
from gaussian_splat_ipu_tpu.train import trainer
from gaussian_splat_ipu_tpu.utils.config import RasterConfig


class ShardedRenderOutput(NamedTuple):
    image: jnp.ndarray        # (H, W, 4) tile-row-sharded across the mesh
    tile_counts: jnp.ndarray  # (rows_pad * tiles_x,) i32, sharded
    overflow: jnp.ndarray     # () i32, summed over devices (replicated)
    num_pairs: jnp.ndarray    # () i32, summed over devices (replicated)
    visible: jnp.ndarray      # (N,) bool, gaussian-sharded frustum mask
    truncated: jnp.ndarray    # () i32 pairs past the per-tile work bound,
    #                           summed over devices (see RenderOutput)
    exchange_overflow: jnp.ndarray  # () i32 splat rows dropped at the
    #                           all_to_all bucket capacity, summed over
    #                           devices (0 on the all_gather path)


# -- packed projected-splat wire format (the all_gather payload) -----------
_PACK_COLS = 12


def _pack_splats(sp: ProjectedSplats) -> jnp.ndarray:
    return jnp.concatenate([
        sp.xy, sp.depth[:, None], sp.conic, sp.color,
        sp.opacity[:, None], sp.radius,
    ], axis=-1)  # (n, 12)


def _unpack_splats(f: jnp.ndarray) -> ProjectedSplats:
    return ProjectedSplats(
        xy=f[:, 0:2], depth=f[:, 2], conic=f[:, 3:6], color=f[:, 6:9],
        opacity=f[:, 9], radius=f[:, 10:12])


def _rows_per_device(cfg: RasterConfig, num_devices: int) -> int:
    """Tile rows per device, rounded UP to a multiple of tile_group so
    every strip covers whole group rows (no boundary group is binned
    twice; the tail device's phantom rows are clamped in bin_splats).
    This makes grouped configs (tile_group > 1 + exact_tile_test, as in
    the 1M default) valid on any mesh size."""
    rows = -(-cfg.tiles_y // num_devices)
    g = cfg.tile_group
    return -(-rows // g) * g


def _dest_strip_span(sp: ProjectedSplats, cfg: RasterConfig, rows: int):
    """Destination-device range [dest_lo, dest_lo + span) per local splat.

    Device j owns tile rows [j*rows, (j+1)*rows); a splat's footprint
    rectangle (3-sigma tile coverage) maps to the contiguous device range
    covering its tile-row span. span = 0 for culled splats. `rows` is
    static, so the divisions strength-reduce at compile time.
    """
    _, y0, nx, ny = binning.tile_ranges_of(sp, cfg)
    dest_lo = y0 // rows
    dest_hi = (y0 + jnp.maximum(ny, 1) - 1) // rows
    span = jnp.where((nx > 0) & (ny > 0), dest_hi - dest_lo + 1, 0)
    return dest_lo, span.astype(jnp.int32)


def _route_all_to_all(packed: jnp.ndarray, dest_lo: jnp.ndarray,
                      span: jnp.ndarray, axis: str, d: int, cap: int):
    """Bucket local splat rows by destination device and all_to_all them.

    packed: (nloc, F) locally-projected splat rows; dest_lo/span: the
    destination-device range each row must reach. Each of the d
    destinations gets a fixed `cap`-row bucket (static shapes); rows past
    a bucket's capacity are dropped AND counted — the bounded-channel +
    counted-overflow discipline of the pair table (and of the reference's
    300-slot lattice channels, src/splat/edge_builder.cpp:35-84).

    Returns (recv (d*cap, F) — rows routed TO this device, globally
    gaussian-id-ordered so depth-tie-breaking matches the single-device
    renderer exactly; send_overflow () i32 — rows this device dropped).

    Differentiable in `packed`: the routing indices are integer-only, the
    row gather transposes to a scatter-add, and the all_to_all transposes
    to its inverse permutation — splat cotangents ride the same links
    back to the owning shard.
    """
    nloc, nfeat = packed.shape
    p = d * cap  # pair-expansion capacity == total send-buffer slots

    # Expand to (splat, destination) pairs — the scatter+cummax expansion
    # of render/binning.py. Pairs come out ordered by gaussian id,
    # destinations ascending within one.
    span_ext = jnp.concatenate([span, jnp.array([p], jnp.int32)])
    ends_cum = jnp.cumsum(span_ext)
    offsets_ext = ends_cum - span_ext
    total = ends_cum[-2]
    first_slot = jnp.where(span_ext > 0, offsets_ext, p)
    iota_n = jnp.arange(nloc + 1, dtype=jnp.int32)
    slot = jnp.arange(p, dtype=jnp.int32)
    # d is tiny (<= mesh axis), so dest_lo packs into the low bits of the
    # segment-start key and forward-fills with the SAME cummax that fills
    # gid — no separate (P,)-element gather.
    dbits = max((d + 1).bit_length(), 1)
    dest_ext = jnp.concatenate([dest_lo, jnp.array([d], jnp.int32)])
    key_at = jnp.zeros((p,), jnp.int32).at[first_slot].max(
        (iota_n << dbits) | dest_ext, mode="drop")
    key_fill = jax.lax.cummax(key_at)
    gid = key_fill >> dbits
    prev_gid = jnp.concatenate([jnp.full((1,), -1, jnp.int32), gid[:-1]])
    rank = slot - jax.lax.cummax(jnp.where(gid != prev_gid, slot, 0))
    is_pad = gid >= nloc
    dest = jnp.where(is_pad, d, (key_fill & ((1 << dbits) - 1)) + rank)

    # Sort pairs by destination (single-key i32 radix fast path), gid
    # riding as the one carried value; stability keeps gid ascending
    # within each destination bucket.
    dest_s, gid_s = jax.lax.sort((dest, jnp.where(is_pad, nloc, gid)),
                                 num_keys=1)
    prev_d = jnp.concatenate([jnp.full((1,), -1, jnp.int32), dest_s[:-1]])
    lrank = slot - jax.lax.cummax(jnp.where(dest_s != prev_d, slot, 0))
    keep = (dest_s < d) & (lrank < cap)
    out_slot = jnp.where(keep, dest_s * cap + lrank, p)
    idx = jnp.full((p,), nloc, jnp.int32).at[out_slot].set(gid_s,
                                                           mode="drop")

    packed_ext = jnp.concatenate(
        [packed, jnp.zeros((1, nfeat), packed.dtype)])
    send = packed_ext[idx]                          # (d*cap, F)
    recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0,
                              tiled=True)

    # Counted drops: expansion-table tail + over-capacity bucket rows.
    bounds = jnp.searchsorted(dest_s, jnp.arange(d + 1, dtype=jnp.int32),
                              side="left").astype(jnp.int32)
    bucket_demand = bounds[1:] - bounds[:-1]
    send_overflow = (jnp.maximum(total - p, 0)
                     + jnp.sum(jnp.maximum(bucket_demand - cap, 0)))
    return recv, send_overflow


def _exchange_capacity(nloc: int, d: int,
                       requested: int | None = None) -> int:
    """Per-destination bucket rows: an even nloc/d share with 4x slack for
    view-dependent imbalance, 128-row aligned, never more than nloc (at
    cap == nloc no routing can overflow a bucket, only the expansion)."""
    if requested is not None:
        cap = requested
    else:
        cap = max(min(4 * nloc // max(d, 1), nloc), 128)
    return -(-cap // 128) * 128


def default_pair_budget(cfg: RasterConfig, d: int) -> int:
    """Per-device pair-table budget used when the caller passes no
    pair_capacity: an even share of the global table with 2x slack for
    view-dependent imbalance, chunk-aligned. ONE definition — the train
    CLI's densify pair-demand guard compares against this same budget."""
    per = max(2 * cfg.pair_capacity // d, 4 * cfg.chunk_size)
    return -(-per // cfg.chunk_size) * cfg.chunk_size


def _untile_rows(tiles: jnp.ndarray, cfg: RasterConfig,
                 rows_total: int) -> jnp.ndarray:
    """(rows_total * tiles_x, NPIX, 4) -> (H, W, 4), cropping phantom rows."""
    c = tiles.shape[-1]
    x = tiles.reshape(rows_total, cfg.tiles_x, cfg.tile_height,
                      cfg.tile_width, c)
    x = x.transpose(0, 2, 1, 3, 4).reshape(rows_total * cfg.tile_height,
                                           cfg.padded_width, c)
    return x[:cfg.image_height, :cfg.image_width]


def render_sharded(model: GaussianModel, camera: Camera, cfg: RasterConfig,
                   mesh, axis: str = SHARD_AXIS, use_pallas: bool = True,
                   pair_capacity: int | None = None,
                   xy_probe: jnp.ndarray | None = None,
                   exchange: str = "all_to_all",
                   exchange_capacity: int | None = None
                   ) -> ShardedRenderOutput:
    """Render one frame across the mesh. Differentiable end-to-end.

    model must be sharded along N on `axis` (parallel.mesh.shard_model);
    camera is replicated. Returns the image sharded by tile rows. Jit with
    static cfg/mesh/axis/use_pallas/pair_capacity.

    xy_probe: optional (N, 2) zeros sharded like the model — the screen-
    space gradient probe for density control (train/densify.py): grads
    w.r.t. it are per-gaussian pixel-position gradients, and they land
    already sharded (the probe never crosses the mesh).

    exchange: "all_to_all" (default) routes each projected splat only to
    the devices whose row strips it touches, through `exchange_capacity`-
    row buckets (counted overflow in .exchange_overflow) — per-device
    memory and interconnect traffic scale with strip-crossing splats, not
    global N.
    "all_gather" replicates every projected splat (the O(N)-per-device
    fallback; exact whenever the pair table fits).
    """
    if xy_probe is None:
        xy_probe = jnp.zeros((model.num_gaussians, 2), jnp.float32)
    return _run_sharded(False, (model, camera, xy_probe),
                        model.num_gaussians, cfg, mesh, axis, use_pallas,
                        pair_capacity, exchange, exchange_capacity)


def render_splats_sharded(splats: ProjectedSplats, cfg: RasterConfig,
                          mesh, axis: str = SHARD_AXIS,
                          use_pallas: bool = True,
                          pair_capacity: int | None = None,
                          exchange: str = "all_to_all",
                          exchange_capacity: int | None = None
                          ) -> ShardedRenderOutput:
    """render_sharded after its projection: exchange, bin and rasterize
    already-projected splats, sharded along N on `axis`. Given the same
    splats it is bit-identical to pipeline.render_splats, which separates
    what the mesh changes from what a different projection program does."""
    return _run_sharded(True, (splats,), splats.xy.shape[0], cfg, mesh,
                        axis, use_pallas, pair_capacity, exchange,
                        exchange_capacity)


def _run_sharded(projected, args, n, cfg, mesh, axis, use_pallas,
                 pair_capacity, exchange, exchange_capacity):
    d = mesh.shape[axis]
    if pair_capacity is None:
        pair_capacity = default_pair_budget(cfg, d)
    pair_capacity = -(-pair_capacity // cfg.chunk_size) * cfg.chunk_size
    cap = _exchange_capacity(-(-n // d), d, exchange_capacity)
    program = _render_sharded_program(cfg, mesh, axis, use_pallas,
                                      pair_capacity, exchange, cap,
                                      projected)
    (image, counts, overflow, num_pairs, visible, truncated,
     exchange_overflow) = program(*args)
    return ShardedRenderOutput(image=image, tile_counts=counts,
                               overflow=overflow, num_pairs=num_pairs,
                               visible=visible, truncated=truncated,
                               exchange_overflow=exchange_overflow)


@functools.lru_cache(maxsize=None)
def _render_sharded_program(cfg, mesh, axis, use_pallas, pair_capacity,
                            exchange, cap, projected):
    """Build (once per static config) the jitted shard_map render program.

    render_sharded is called eagerly all over the test suite and the
    interactive/train apps; without this cache every call constructed a
    fresh closure and re-traced + re-lowered the full program (~40 s on
    the CPU mesh). Mesh and RasterConfig are hashable by value, so equal
    configs share one compiled program per process. `projected`: the
    program takes projected splats (render_splats_sharded) instead of the
    model, camera and probe."""
    d = mesh.shape[axis]
    rows = _rows_per_device(cfg, d)

    def strip_fn(sp_local):
        packed = _pack_splats(sp_local)
        if exchange == "all_to_all":
            dest_lo, span = _dest_strip_span(sp_local, cfg, rows)
            routed, xovf = _route_all_to_all(packed, dest_lo, span, axis,
                                             d, cap)
        else:
            routed = jax.lax.all_gather(packed, axis, axis=0, tiled=True)
            xovf = jnp.int32(0)
        sp = _unpack_splats(routed)

        row_lo = jax.lax.axis_index(axis) * rows
        binned = binning.bin_splats(sp, cfg, row_lo=row_lo, num_rows=rows,
                                    pair_capacity=pair_capacity)
        offset = row_lo * cfg.tiles_x
        if use_pallas:
            from gaussian_splat_ipu_tpu.render.kernels import rasterize
            tiles = rasterize.rasterize_tiles(binned, cfg,
                                              tile_offset=offset)
        else:
            tiles = tile_raster.rasterize_tiles_jnp(binned, cfg,
                                                    tile_offset=offset)
        counts = binned.tile_ends - binned.tile_starts
        overflow = jax.lax.psum(binned.overflow, axis)
        num_pairs = jax.lax.psum(binned.num_pairs, axis)
        truncated = jax.lax.psum(
            pipeline.truncated_pairs(counts, cfg, row_lo), axis)
        return (tiles, counts, overflow, num_pairs,
                sp_local.radius[:, 0] > 0.0, truncated,
                jax.lax.psum(xovf, axis))

    if projected:
        shard_fn, in_specs = strip_fn, (P(axis),)
    else:
        def shard_fn(model_shard, camera_rep, probe_shard):
            return strip_fn(project_gaussians(model_shard, camera_rep, cfg,
                                              xy_probe=probe_shard))
        in_specs = (P(axis), P(), P(axis))

    mapped = shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs,
        out_specs=(P(axis), P(axis), P(), P(), P(axis), P(), P()),
        check_vma=False,  # custom_vjp inside defeats the varying-axis check
    )

    @jax.jit
    def run(*args):
        (tiles, counts, overflow, num_pairs, visible, truncated,
         exchange_overflow) = mapped(*args)
        image = _untile_rows(tiles, cfg, rows * d)
        return (image, counts, overflow, num_pairs, visible, truncated,
                exchange_overflow)

    return run


def render_image_sharded(model, camera, cfg: RasterConfig, mesh,
                         axis: str = SHARD_AXIS, use_pallas: bool = True,
                         pair_capacity: int | None = None,
                         exchange: str = "all_to_all",
                         exchange_capacity: int | None = None
                         ) -> jnp.ndarray:
    return render_sharded(model, camera, cfg, mesh, axis, use_pallas,
                          pair_capacity, exchange=exchange,
                          exchange_capacity=exchange_capacity).image


def render_views_sharded(model: GaussianModel, cameras: Camera,
                         cfg: RasterConfig, mesh,
                         view_axis: str = VIEW_AXIS,
                         shard_axis: str = SHARD_AXIS,
                         use_pallas: bool = True,
                         pair_capacity: int | None = None,
                         exchange: str = "all_to_all",
                         exchange_capacity: int | None = None,
                         with_stats: bool = False):
    """Render a BATCH of views over a 2D (view, shard) mesh.

    cameras: Camera pytree with a leading view dimension V (divisible by
    the view-axis size); model sharded along N on the shard axis and
    replicated across view groups. Each view group renders its slice of
    the batch (data parallelism over frames — the second classic axis,
    which the reference cannot express at all); within a group the
    gaussians/tile-rows sharding of render_sharded applies. Returns
    (V, H, W, 4), view- and tile-row-sharded — or (images, stats) with
    with_stats=True, where stats holds the summed drop counters
    (exchange_overflow / overflow / truncated: counted, never silent).
    Differentiable; the transpose of the view-axis replication psums
    parameter gradients.
    """
    d = mesh.shape[shard_axis]
    rows = _rows_per_device(cfg, d)
    nloc_rows_total = rows * d
    if pair_capacity is None:
        pair_capacity = default_pair_budget(cfg, d)
    pair_capacity = -(-pair_capacity // cfg.chunk_size) * cfg.chunk_size
    cap = _exchange_capacity(-(-model.num_gaussians // d), d,
                             exchange_capacity)
    cam_treedef = jax.tree_util.tree_structure(
        jax.tree.map(lambda x: x[0], cameras))
    program = _render_views_program(cfg, mesh, view_axis, shard_axis,
                                    use_pallas, pair_capacity, exchange,
                                    cap, cam_treedef)
    images, stats = program(model,
                            tuple(jax.tree_util.tree_leaves(cameras)))
    return (images, stats) if with_stats else images


@functools.lru_cache(maxsize=None)
def _render_views_program(cfg, mesh, view_axis, shard_axis, use_pallas,
                          pair_capacity, exchange, cap, cam_treedef):
    """Memoized jitted view-batch program (same rationale as
    _render_sharded_program: an eagerly-invoked shard_map closure would
    re-lower per call)."""
    d = mesh.shape[shard_axis]
    rows = _rows_per_device(cfg, d)
    nloc_rows_total = rows * d

    def shard_fn(model_shard, cams_local_leaves):
        def one_view(cam_leaves):
            cam = jax.tree_util.tree_unflatten(cam_treedef, cam_leaves)
            sp_local = project_gaussians(model_shard, cam, cfg)
            packed = _pack_splats(sp_local)
            if exchange == "all_to_all":
                dest_lo, span = _dest_strip_span(sp_local, cfg, rows)
                routed, xovf = _route_all_to_all(packed, dest_lo, span,
                                                 shard_axis, d, cap)
            else:
                routed = jax.lax.all_gather(packed, shard_axis, axis=0,
                                            tiled=True)
                xovf = jnp.int32(0)
            sp = _unpack_splats(routed)
            row_lo = jax.lax.axis_index(shard_axis) * rows
            binned = binning.bin_splats(sp, cfg, row_lo=row_lo,
                                        num_rows=rows,
                                        pair_capacity=pair_capacity)
            offset = row_lo * cfg.tiles_x
            if use_pallas:
                from gaussian_splat_ipu_tpu.render.kernels import rasterize
                tiles = rasterize.rasterize_tiles(binned, cfg,
                                                  tile_offset=offset)
            else:
                tiles = tile_raster.rasterize_tiles_jnp(
                    binned, cfg, tile_offset=offset)
            counts = binned.tile_ends - binned.tile_starts
            stats = jnp.stack([
                xovf, binned.overflow,
                pipeline.truncated_pairs(counts, cfg, row_lo)])
            return tiles, stats

        # Sequential over the local view slice: each view already uses the
        # whole shard group; parallelism across views comes from the mesh.
        tiles, stats = jax.lax.map(one_view, cams_local_leaves)
        # Drop counters, like the single-view renderer's, are COUNTED and
        # surfaced, never silent: sum over local views + both mesh axes.
        stats = jax.lax.psum(jnp.sum(stats, axis=0),
                             (view_axis, shard_axis))
        return tiles, stats

    mapped = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(shard_axis), P(view_axis)),
        out_specs=(P(view_axis, shard_axis), P()),
        check_vma=False,
    )

    @jax.jit
    def run(model, cam_leaves):
        tiles, stats = mapped(model, cam_leaves)  # (V, T_local*d, NPIX, 4)
        images = jax.vmap(
            lambda t: _untile_rows(t, cfg, nloc_rows_total))(tiles)
        return images, {"exchange_overflow": stats[0],
                        "overflow": stats[1], "truncated": stats[2]}

    return run


def make_view_batch_train_step(mesh, raster_cfg: RasterConfig,
                               train_cfg: trainer.TrainConfig,
                               view_axis: str = VIEW_AXIS,
                               shard_axis: str = SHARD_AXIS,
                               use_pallas: bool = True,
                               pair_capacity: int | None = None):
    """Jitted train step over a camera/target batch on a (view, shard)
    mesh: per-view losses averaged across the batch; gradient psum over
    the view axis falls out of the replication transpose."""
    tx = trainer.make_optimizer(train_cfg)

    def loss_fn(params, cameras, targets):
        images, stats = render_views_sharded(
            params, cameras, raster_cfg, mesh, view_axis, shard_axis,
            use_pallas, pair_capacity, with_stats=True)
        losses_v = jax.vmap(
            lambda im, tg: loss_lib.render_loss(im, tg,
                                                train_cfg.ssim_weight))(
            images, targets)
        return jnp.mean(losses_v), stats

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state: trainer.TrainState, cameras, targets):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, cameras, targets)
        params, opt_state = trainer.apply_param_updates(
            tx, state.params, grads, state.opt_state)
        # stats carries the summed drop counters (exchange_overflow /
        # overflow / truncated) — check them like RenderOutput's: dropped
        # rows corrupt gradients silently otherwise.
        return trainer.TrainState(params=params, opt_state=opt_state,
                                  step=state.step + 1), loss, stats

    return step


def grow_capacity_sharded(mesh, state, dstate, new_capacity: int,
                          axis: str = SHARD_AXIS):
    """Slot-buffer growth on SHARDED training state (the distributed
    analogue of train/densify.py::grow_capacity).

    Each device pads ITS slice of every gaussian-axis leaf with dead
    slots, so the grown buffers keep the even P(axis) layout with no
    gather or reshard (growth at the GLOBAL end would land every new slot
    on the last device). New slots are invisible and unallocated
    (opacity/log_scales -30, identity quats, alive=False); the
    rank-and-scatter surgery allocates by the alive mask, so interleaved
    dead runs are as good as a contiguous tail. One recompile per growth,
    exactly like the single-device path.
    """
    from gaussian_splat_ipu_tpu.train import densify as densify_lib

    d = mesh.shape[axis]
    old = dstate.alive.shape[0]
    if new_capacity == old:
        return state, dstate
    if new_capacity < old or new_capacity % d or old % d:
        raise ValueError(f"capacity {old} -> {new_capacity} must grow in "
                         f"multiples of the mesh size {d}")
    pad_per = (new_capacity - old) // d

    def grow(x, make_pad):
        spec = P(*([axis] + [None] * (x.ndim - 1)))

        def local(xs):
            return jnp.concatenate(
                [xs, make_pad((pad_per,) + xs.shape[1:], xs.dtype)], 0)

        return shard_map(local, mesh=mesh, in_specs=(spec,),
                         out_specs=spec)(x)

    def zeros(shape, dt):
        return jnp.zeros(shape, dt)

    def const(v):
        return lambda shape, dt: jnp.full(shape, v, dt)

    def quat_pad(shape, dt):
        return jnp.tile(jnp.array([[1.0, 0.0, 0.0, 0.0]], dt),
                        (shape[0], 1))

    p = state.params
    params = GaussianModel(
        means=grow(p.means, zeros),
        log_scales=grow(p.log_scales, const(-30.0)),
        quats=grow(p.quats, quat_pad),
        opacities=grow(p.opacities, const(-30.0)),
        sh=grow(p.sh, zeros))
    opt_state = jax.tree.map(
        lambda x: grow(x, zeros)
        if (isinstance(x, jnp.ndarray) and x.ndim >= 1
            and x.shape[0] == old) else x,
        state.opt_state)
    new_state = trainer.TrainState(params=params, opt_state=opt_state,
                                   step=state.step)
    new_dstate = densify_lib.DensifyState(
        grad_sum=grow(dstate.grad_sum, zeros),
        vis_count=grow(dstate.vis_count, zeros),
        alive=grow(dstate.alive, zeros),
        key=dstate.key)
    return new_state, new_dstate


def make_sharded_densify_train_step(mesh, raster_cfg: RasterConfig,
                                    train_cfg: trainer.TrainConfig,
                                    axis: str = SHARD_AXIS,
                                    use_pallas: bool = True,
                                    pair_capacity: int | None = None,
                                    jit: bool = True):
    """Distributed train step with density-control statistics.

    step(state, dstate, camera, target) -> (state, dstate, loss): the
    sharded analogue of train.densify.make_train_step — screen gradients
    come from a zero probe that is sharded like the model, so the stats
    accumulate shard-locally with no extra collectives. Between-event
    surgery (train.densify.densify_and_prune / reset_opacity) runs on the
    sharded state directly under jit: the rank-and-scatter is global over
    the slot buffer, and GSPMD inserts the collectives it needs (events
    are rare, every densify_every steps).
    """
    from gaussian_splat_ipu_tpu.train import densify as densify_lib

    tx = trainer.make_optimizer(train_cfg)
    half_wh = jnp.array([0.5 * raster_cfg.image_width,
                         0.5 * raster_cfg.image_height], jnp.float32)

    def loss_fn(params, probe, camera, target):
        out = render_sharded(params, camera, raster_cfg, mesh, axis,
                             use_pallas, pair_capacity, xy_probe=probe)
        return (loss_lib.render_loss(out.image, target,
                                     train_cfg.ssim_weight), out.visible)

    def step(state: trainer.TrainState, dstate, camera: Camera,
             target: jnp.ndarray):
        probe = jnp.zeros((state.params.num_gaussians, 2), jnp.float32)
        (loss, visible), (grads, gxy) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(
            state.params, probe, camera, target)
        gnorm = jnp.linalg.norm(gxy * half_wh[None, :], axis=-1)
        dstate = densify_lib.DensifyState(
            grad_sum=dstate.grad_sum + jnp.where(visible, gnorm, 0.0),
            vis_count=dstate.vis_count + visible.astype(jnp.int32),
            alive=dstate.alive, key=dstate.key)

        params, opt_state = trainer.apply_param_updates(
            tx, state.params, grads, state.opt_state)
        return trainer.TrainState(params=params, opt_state=opt_state,
                                  step=state.step + 1), dstate, loss

    if jit:
        return jax.jit(step, donate_argnums=(0, 1))
    return step  # raw body, for chaining into an epoch lax.scan


def make_sharded_train_step(mesh, raster_cfg: RasterConfig,
                            train_cfg: trainer.TrainConfig,
                            axis: str = SHARD_AXIS, use_pallas: bool = True,
                            pair_capacity: int | None = None):
    """Build a jitted distributed train step.

    Collectives: the forward all_gathers compact projected splats; its
    autodiff transpose reduce-scatters splat gradients back to the owning
    shard, so parameter gradients land already sharded — there is no
    separate gradient all-reduce to schedule (the overlap the north star
    asks for falls out of XLA's latency-hiding scheduler on the
    reduce_scatter).
    """
    tx = trainer.make_optimizer(train_cfg)

    def loss_fn(params, camera, target):
        image = render_image_sharded(params, camera, raster_cfg, mesh, axis,
                                     use_pallas, pair_capacity)
        return loss_lib.render_loss(image, target, train_cfg.ssim_weight)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state: trainer.TrainState, camera: Camera,
             target: jnp.ndarray):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, camera,
                                                  target)
        params, opt_state = trainer.apply_param_updates(
            tx, state.params, grads, state.opt_state)
        return trainer.TrainState(params=params, opt_state=opt_state,
                                  step=state.step + 1), loss

    return step
