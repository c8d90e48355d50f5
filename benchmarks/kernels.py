"""Hand-written kernels against what XLA makes of the plain versions.

Times, on the GPU, at 1280x720 for two scenes (37,941 gaussians at the
default config; 1,048,576 gaussians at tile_group=3 + exact_tile_test):

  * the rasterize forward: the Triton kernel against the jnp spec
    (render/tile_raster.py);
  * forward + backward (gradient of a random projection of the tiles):
    kernel against the spec's autodiff;
  * a whole frame (render) and a whole train step (trainer.train_step),
    kernel against spec;
  * the exact coverage masks of binning: the 64-step fori_loop as it is
    against the same loop fully unrolled;
  * the pair expansion of binning (scatter + cummax + rank + row gather).

Each time is the median host wall-clock of `--reps` calls that end in
block_until_ready, after one warm-up call. Prints one JSON object per
measurement, then the card's name and power limit. Needs a GPU.

    python benchmarks/kernels.py [--reps 7] [--spec-reps 2]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def timed(fn, *args, reps: int) -> float:
    """Median ms of fn(*args) over reps calls, after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--spec-reps", type=int, default=2)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX sees {jax.devices()}")

    from gaussian_splat_ipu_tpu.models.camera import Camera
    from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu.render import binning, tile_raster
    from gaussian_splat_ipu_tpu.render.kernels import rasterize
    from gaussian_splat_ipu_tpu.render.pipeline import render, render_image
    from gaussian_splat_ipu_tpu.render.projection import project_gaussians
    from gaussian_splat_ipu_tpu.runtime import engine
    from gaussian_splat_ipu_tpu.train import trainer
    from gaussian_splat_ipu_tpu.utils.config import RasterConfig

    engine.enable_compilation_cache()
    bb = np.array([1.0, 1.0, 1.0], np.float32)
    cam = Camera.orbit(-bb, bb, float(np.radians(40.0)), 1280 / 720)

    def emit(**kw):
        kw["device_kind"] = jax.devices()[0].device_kind
        print(json.dumps(kw), flush=True)

    scenes = [
        ("37941", 37_941, RasterConfig()),
        ("1m_g3_exact", 1 << 20, RasterConfig(tile_group=3,
                                              exact_tile_test=True)),
    ]
    for name, n, cfg in scenes:
        model = GaussianModel.random(jax.random.PRNGKey(0), n, extent=1.0)
        probe = dataclasses.replace(cfg, pair_capacity=1 << 23)
        demand = int(jax.jit(lambda m: render(m, cam, probe, False)
                             .num_pairs)(model))
        cap = -(-int(1.15 * demand) // cfg.chunk_size) * cfg.chunk_size
        cfg = dataclasses.replace(cfg, pair_capacity=cap)
        emit(scene=name, gaussians=n, pairs=demand, pair_capacity=cap)
        binned = jax.jit(lambda m: binning.bin_splats(
            project_gaussians(m, cam, cfg), cfg))(model)
        cot = jax.random.normal(jax.random.PRNGKey(1),
                                (cfg.num_tiles, cfg.pixels_per_tile, 4))

        def fwd(b, c):
            return rasterize.rasterize_tiles(b, c)

        def spec_fwd(b, c):
            return tile_raster.rasterize_tiles_jnp(b, c)

        def grad_of(raster):
            def f(feats, b, c):
                return jnp.sum(raster(b._replace(features=feats), c) * cot)
            return jax.grad(f)

        rows = [
            ("fwd_kernel", jax.jit(fwd, static_argnums=1),
             (binned, cfg), args.reps),
            ("fwd_spec", jax.jit(spec_fwd, static_argnums=1),
             (binned, cfg), args.spec_reps),
            ("fwdbwd_kernel", jax.jit(grad_of(fwd), static_argnums=2),
             (binned.features, binned, cfg), args.reps),
            ("fwdbwd_spec", jax.jit(grad_of(spec_fwd), static_argnums=2),
             (binned.features, binned, cfg), args.spec_reps),
        ]
        frame = jax.jit(lambda m, c, k: render(m, cam, c, k).image,
                        static_argnums=(1, 2))
        rows += [
            ("frame_kernel", frame, (model, cfg, True), args.reps),
            ("frame_spec", frame, (model, cfg, False), args.spec_reps),
        ]
        target = jax.jit(render_image, static_argnums=(2, 3))(
            model, cam, cfg, True)
        tc = trainer.TrainConfig(ssim_weight=0.0)
        state = trainer.init_state(model, tc)
        step = jax.jit(lambda s, k: trainer.train_step(
            s, cam, target, cfg, tc, k), static_argnums=1)
        rows += [
            ("train_step_kernel", step, (state, True), args.reps),
            ("train_step_spec", step, (state, False), args.spec_reps),
        ]
        for label, fn, fargs, reps in rows:
            emit(scene=name, what=label, ms=timed(fn, *fargs, reps=reps))

        # Binning stages (gradient-free geometry).
        sp = jax.jit(lambda m: project_gaussians(m, cam, cfg))(model)
        g = cfg.tile_group

        def group_space(s):
            x0, y0, nx, ny = binning.tile_ranges_of(s, cfg)
            x1, y1 = x0 + jnp.maximum(nx - 1, 0), y0 + jnp.maximum(ny - 1, 0)
            gx0, gy0 = x0 // g, y0 // g
            return (gx0, gy0, jnp.where(nx > 0, x1 // g - gx0 + 1, 0),
                    jnp.where(ny > 0, y1 // g - gy0 + 1, 0))

        def masks(s):
            return binning._coverage_masks(
                s, cfg, *group_space(s), cell_w=g * cfg.tile_width,
                cell_h=g * cfg.tile_height)

        loop_fn = jax.jit(masks)
        emit(scene=name, what="coverage_masks_fori_loop",
             ms=timed(loop_fn, sp, reps=args.reps))
        unrolled = functools.partial(jax.lax.fori_loop, unroll=True)
        orig = jax.lax.fori_loop
        jax.lax.fori_loop = unrolled
        try:
            unroll_fn = jax.jit(masks).lower(sp).compile()
        finally:
            jax.lax.fori_loop = orig
        emit(scene=name, what="coverage_masks_unrolled",
             ms=timed(unroll_fn, sp, reps=args.reps))

        def expansion(s):
            # bin_splats' expansion and its per-pair row gather.
            ncov = jnp.prod(jnp.stack(group_space(s)[2:]), axis=0)
            gid, rank, _ = binning.expand_pairs(ncov.astype(jnp.int32), cap)
            packed = jnp.zeros((ncov.shape[0] + 1, 16), jnp.float32)
            return packed[gid], rank

        emit(scene=name, what="pair_expansion",
             ms=timed(jax.jit(expansion), sp, reps=args.reps))
        emit(scene=name, what="bin_splats",
             ms=timed(jax.jit(lambda s: binning.bin_splats(s, cfg)), sp,
                      reps=args.reps))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
