"""Headline benchmark: forward render fps at 1280x720 on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

The reference publishes no numbers: its only implied target is interactive
rendering of its demo scenes on one IPU. We therefore benchmark the
reference's own headline workload — point_cloud_12.ply (37,941 gaussians;
the largest checked-in scene) at the reference's fixed 1280x720 framebuffer
(tile_config.hpp:5-6) — and report vs_baseline against a 30 fps
interactive-rate bar. Falls back to an equally-sized synthetic scene when
the reference data mount is absent.

Measurement method: K orbit frames chained inside ONE jitted program
(lax.scan) with a scalar reduction fetched at the end, timed at two K values
so fixed dispatch/transfer costs cancel: per-frame = (t_K2 - t_K1)/(K2 - K1).
"""

from __future__ import annotations

import json
import time

import numpy as np

REFERENCE_PLY = "/root/reference/data/point_cloud_12.ply"
BASELINE_FPS = 30.0
WIDTH, HEIGHT = 1280, 720
K1, K2 = 1, 31


def load_model_and_bounds():
    import jax
    from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel

    try:
        from gaussian_splat_ipu_tpu.io.scene import load_scene
        scene = load_scene(REFERENCE_PLY)
        return scene.model, scene.bb_min, scene.bb_max
    except (OSError, ValueError):
        model = GaussianModel.random(jax.random.PRNGKey(0), 37_941,
                                     extent=1.0)
        bb = np.array([1.0, 1.0, 1.0], np.float32)
        return model, -bb, bb


def main():
    import jax
    import jax.numpy as jnp

    from gaussian_splat_ipu_tpu.runtime import engine

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX sees {jax.devices()}")
    # Persistent compile cache: repeat bench runs skip the XLA compiles
    # (the saveExe/loadExe analogue, runtime/engine.py).
    engine.enable_compilation_cache()

    from gaussian_splat_ipu_tpu.models.camera import Camera
    from gaussian_splat_ipu_tpu.render.pipeline import render
    from gaussian_splat_ipu_tpu.utils.config import RasterConfig

    model, bb_min, bb_max = load_model_and_bounds()
    n = model.num_gaussians
    cfg = RasterConfig(image_width=WIDTH, image_height=HEIGHT)
    fov = float(np.radians(40.0))
    aspect = WIDTH / HEIGHT

    # Right-size the pair table: every binning pass is O(capacity), so the
    # 2^18 safety default would spend ~2x the frame time this scene needs.
    # Probe the orbit's worst-case pair demand once, then rebuild the config
    # with 1.5x headroom (chunk-aligned power of two; zero overflow =>
    # pixel-exact) — the auto-tuning a production renderer would persist.
    import dataclasses

    def demand_at(m, a):
        out = render(m, Camera.orbit(bb_min, bb_max, fov, aspect,
                                     rot_y_deg=a), cfg, True)
        return out.num_pairs + out.overflow

    probe = jax.jit(demand_at)
    demand = max(max(int(probe(model, jnp.float32(a)))
                     for a in np.linspace(0.0, 360.0, 16)), 1)
    # Chunk-aligned, not power-of-two: every binning pass is O(capacity),
    # so pow2 rounding can waste up to 2x of the dominant frame cost.
    cap = max(-(-int(1.2 * demand) // cfg.chunk_size) * cfg.chunk_size,
              4 * cfg.chunk_size)
    if cap < cfg.pair_capacity:
        cfg = dataclasses.replace(cfg, pair_capacity=cap)

    def fps_for(render_cfg):
        def frames(model, angles):
            def body(acc, a):
                cam = Camera.orbit(bb_min, bb_max, fov, aspect,
                                   rot_y_deg=a)
                out = render(model, cam, render_cfg, True)
                # Consume every channel so nothing is DCE'd.
                return acc + out.image.mean(), None
            acc, _ = jax.lax.scan(body, jnp.float32(0.0), angles)
            return acc

        jf = jax.jit(frames)
        a1 = jnp.linspace(0.0, 360.0, K1, dtype=jnp.float32)
        a2 = jnp.linspace(0.0, 360.0, K2, dtype=jnp.float32)
        float(jf(model, a1))  # compile + warm
        float(jf(model, a2))

        def measure_once():
            t0 = time.perf_counter()
            v1 = float(jf(model, a1))
            t1 = time.perf_counter() - t0
            t0 = time.perf_counter()
            v2 = float(jf(model, a2))
            t2 = time.perf_counter() - t0
            assert np.isfinite(v1) and np.isfinite(v2)
            return (t2 - t1) / (K2 - K1)

        # Median of 5 two-point measurements: one sample is vulnerable to
        # a co-scheduled host burst.
        per_frame = float(np.median([measure_once() for _ in range(5)]))
        return 1.0 / per_frame

    fps = fps_for(cfg)

    # Secondary headline: training-step latency (north-star config 3) on
    # the same scene at 640x360 — K chained steps in one program, same
    # two-point method.
    from gaussian_splat_ipu_tpu.train import trainer as trainer_lib
    from gaussian_splat_ipu_tpu.utils.config import (
        RasterConfig as _RC)
    tcfg = _RC(image_width=640, image_height=360,
               pair_capacity=max(cfg.pair_capacity // 2,
                                 4 * cfg.chunk_size))
    tc = trainer_lib.TrainConfig(ssim_weight=0.0)
    cam0 = Camera.orbit(bb_min, bb_max, fov, aspect, rot_y_deg=0.0)
    from gaussian_splat_ipu_tpu.render.pipeline import render_image
    target = jax.jit(render_image, static_argnums=(2, 3))(
        model, cam0, tcfg, True)
    state0 = trainer_lib.init_state(model, tc)

    def steps(state, k_arr):
        def body(s, _):
            s, loss = trainer_lib.train_step(s, cam0, target, tcfg, tc,
                                             True)
            return s, loss
        s, ls = jax.lax.scan(body, state, k_arr)
        return ls[-1]

    js = jax.jit(steps)
    k1 = jnp.zeros((2,), jnp.float32)
    k2 = jnp.zeros((12,), jnp.float32)
    float(js(state0, k1))
    float(js(state0, k2))

    def measure_train():
        t0 = time.perf_counter()
        float(js(state0, k1))
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(js(state0, k2))
        t2 = time.perf_counter() - t0
        return (t2 - t1) / 10.0

    train_ms = 1e3 * float(np.median([measure_train() for _ in range(3)]))

    # Third headline: the 1M-gaussian frame (north-star config 5 scale,
    # reference README.md:8-17 "millions of gaussians") — synthetic scene,
    # demand-probed chunk-aligned capacity, strict kernel, two-point
    # chained-scan timing. Guards the scale the north star names.
    # Config: tile_group=3 + exact_tile_test (group-cell coverage
    # masks); the keys ride the JSON record.
    from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
    n1m = 1 << 20
    model_1m = GaussianModel.random(jax.random.PRNGKey(0), n1m, extent=1.0)
    bb1 = np.array([1.0, 1.0, 1.0], np.float32)
    cfg_1m = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                          pair_capacity=1 << 22, tile_group=3,
                          exact_tile_test=True)

    def demand_1m(m, a):
        out = render(m, Camera.orbit(-bb1, bb1, fov, aspect, rot_y_deg=a),
                     cfg_1m, True)
        return out.num_pairs + out.overflow

    d1m = int(jax.jit(demand_1m)(model_1m, jnp.float32(0.0)))
    cap_1m = max(-(-int(1.15 * d1m) // cfg_1m.chunk_size)
                 * cfg_1m.chunk_size, 4 * cfg_1m.chunk_size)
    cfg_1m = dataclasses.replace(cfg_1m, pair_capacity=cap_1m)

    def frames_1m(m, angles):
        def body(acc, a):
            cam = Camera.orbit(-bb1, bb1, fov, aspect, rot_y_deg=a)
            out = render(m, cam, cfg_1m, True)
            return acc + out.image[::97, ::97].sum(), None
        acc, _ = jax.lax.scan(body, jnp.float32(0.0), angles)
        return acc

    jf1m = jax.jit(frames_1m)
    b1 = jnp.linspace(0.0, 90.0, 1, dtype=jnp.float32)
    b2 = jnp.linspace(0.0, 90.0, 7, dtype=jnp.float32)
    float(jf1m(model_1m, b1))
    float(jf1m(model_1m, b2))

    def measure_1m():
        t0 = time.perf_counter()
        float(jf1m(model_1m, b1))
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(jf1m(model_1m, b2))
        t2 = time.perf_counter() - t0
        return (t2 - t1) / 6.0

    ms_1m = 1e3 * float(np.median([measure_1m() for _ in range(3)]))

    # Clustered-1M variant: Gaussian-mixture positions +
    # log-normal scales — occlusion coherence and tile-occupancy skew the
    # uniform scene lacks, so early-exit benefit and sort-segment skew
    # stay on the record. Same probe + timing discipline.
    model_1mc = GaussianModel.clustered(jax.random.PRNGKey(0), n1m,
                                        extent=1.0)
    d1mc = int(jax.jit(demand_1m)(model_1mc, jnp.float32(0.0)))
    cap_1mc = max(-(-int(1.15 * d1mc) // cfg_1m.chunk_size)
                  * cfg_1m.chunk_size, 4 * cfg_1m.chunk_size)
    cfg_1mc = dataclasses.replace(cfg_1m, pair_capacity=cap_1mc)

    def frames_1mc(m, angles):
        def body(acc, a):
            cam = Camera.orbit(-bb1, bb1, fov, aspect, rot_y_deg=a)
            out = render(m, cam, cfg_1mc, True)
            return acc + out.image[::97, ::97].sum(), None
        acc, _ = jax.lax.scan(body, jnp.float32(0.0), angles)
        return acc

    jf1mc = jax.jit(frames_1mc)
    float(jf1mc(model_1mc, b1))
    float(jf1mc(model_1mc, b2))

    def measure_1mc():
        t0 = time.perf_counter()
        float(jf1mc(model_1mc, b1))
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(jf1mc(model_1mc, b2))
        t2 = time.perf_counter() - t0
        return (t2 - t1) / 6.0

    ms_1mc = 1e3 * float(np.median([measure_1mc() for _ in range(3)]))

    # 1M-scale BACKWARD (north-star configs 3+5): full
    # train step (forward + backward rasterize replay + binning VJP
    # scatter-add + projection VJP + adam) at 720p on the uniform 1M
    # scene, same config, demand-probed capacity — single GPU.
    tc_1m = trainer_lib.TrainConfig(ssim_weight=0.0)
    cam_1m = Camera.orbit(-bb1, bb1, fov, aspect, rot_y_deg=0.0)
    target_1m = jax.jit(render_image, static_argnums=(2, 3))(
        model_1m, cam_1m, cfg_1m, True)
    state_1m = trainer_lib.init_state(model_1m, tc_1m)

    def steps_1m(state, k_arr):
        def body(s, _):
            s, loss = trainer_lib.train_step(s, cam_1m, target_1m,
                                             cfg_1m, tc_1m, True)
            return s, loss
        s, ls = jax.lax.scan(body, state, k_arr)
        return ls[-1]

    js1m = jax.jit(steps_1m)
    t1a = jnp.zeros((1,), jnp.float32)
    t1b = jnp.zeros((4,), jnp.float32)
    float(js1m(state_1m, t1a))
    float(js1m(state_1m, t1b))

    def measure_train_1m():
        t0 = time.perf_counter()
        float(js1m(state_1m, t1a))
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(js1m(state_1m, t1b))
        t2 = time.perf_counter() - t0
        return (t2 - t1) / 3.0

    train_1m_ms = 1e3 * float(np.median(
        [measure_train_1m() for _ in range(3)]))

    # ONE JSON line (driver contract); auxiliary metrics ride as extra
    # keys: the 1M-gaussian frame time, the pinned capacities, and
    # config-3 latency — so every
    # headline scale is on the record and reproducible.
    print(json.dumps({
        "metric": f"forward_fps_1280x720_{n}g",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "pair_capacity": cfg.pair_capacity,
        # Msplats/s per GPU: the second primary metric BASELINE.json
        # names — gaussians submitted per second of
        # frame time, headline scene and 1M scale.
        "msplats_per_s": round(fps * n / 1e6, 2),
        "msplats_per_s_1m": round((1e3 / ms_1m) * (n1m / 1e6), 2),
        "train_step_ms_640x360": round(train_ms, 2),
        "frame_ms_1m_720p": round(ms_1m, 2),
        "pair_capacity_1m": cap_1m,
        "frame_ms_1m_clustered": round(ms_1mc, 2),
        "pair_capacity_1m_clustered": cap_1mc,
        "train_step_ms_1m_720p": round(train_1m_ms, 2),
        "config_1m": "tile_group=3,exact_tile_test=1",
        "median_of": 5,
    }))


if __name__ == "__main__":
    main()
