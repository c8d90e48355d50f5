"""Smoke run of the system on the GPU: the quickest proof that it starts.

Drives the main path once through the entry points a user calls, at the
repo's largest supported configuration (1,048,576 gaussians, 1280x720,
tile_group=3, exact_tile_test), and checks every kernel of that path,
compiled for the card, against the repo's plain reference:

  0. device: JAX must see a GPU; prints its kind and the card's name and
     power limit (nvidia-smi);
  1. kernel parity at 1280x720, 32x32 tiles, chunk 128, 37,941 gaussians,
     f32 `highest` matmuls: the rasterize forward against the jnp spec
     (render/tile_raster.py) at tile_group 1 and 3, its gradients against
     the spec's autodiff, and the whole pipeline against the dense oracle
     (render/oracle.py) on a small scene;
  2. render: writes the 1M scene to a PLY in a temporary directory and
     runs the render app (app.main) headless for 16 frames with a probed
     pair capacity, checks the PNG, asserts zero overflow and truncation
     through render(), and prints the steady-state ms per frame;
  3. train: runs the train app (app.train) for 5 steps on that PLY at
     1280x720, checks the loss is finite and the parameters changed, and
     prints the steady-state ms per step;
  4. (only with --multi 4) render_sharded on a 4-GPU mesh against the
     single-device render, bit for bit, from the model and from the same
     projected splats; and one view-batch train step on a (2 views x 2
     shards) mesh with a finite loss.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero and prints no such
line; so does a run without a GPU or outside the repository.

    python chip_smoke.py              # phases 0-3, one GPU
    python chip_smoke.py --multi 4    # phases 0 and 4, four GPUs
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

N_PARITY = 37_941          # the reference demo scene's size
N_MAIN = 1 << 20           # the largest supported configuration
WIDTH, HEIGHT = 1280, 720
FOV_DEG = 40.0

# Tolerances (f32, `highest` matmul precision). The kernel composites one
# pair at a time where the spec multiplies chunk prefixes, so the two
# round differently in the last bits.
FWD_ATOL = 1e-5            # max |kernel - spec| over every pixel channel
GRAD_RTOL = 1e-4           # per feature row: max |err| / max |spec grad|
ORACLE_ATOL = 1e-4         # tiled pipeline vs the dense oracle


def result_line(devices) -> str:
    """The contract's last line for the devices the run used."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    """Raise unless `ok`; a failed check ends the run."""
    if not ok:
        raise AssertionError(f"check failed: {what}")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def median_ms(fn, *args, reps: int = 5) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def orbit(bb_min, bb_max, ry, aspect=WIDTH / HEIGHT):
    from gaussian_splat_ipu_tpu.models.camera import Camera
    return Camera.orbit(bb_min, bb_max, float(np.radians(FOV_DEG)), aspect,
                        rot_y_deg=ry)


def probe_capacity(model, cameras, cfg) -> int:
    """1.3x the worst pair demand over `cameras`, chunk-aligned."""
    import jax
    from gaussian_splat_ipu_tpu.render.pipeline import render

    big = dataclasses.replace(cfg, pair_capacity=1 << 24)
    demand = jax.jit(lambda m, c: render(m, c, big, True).num_pairs)
    worst = max(int(demand(model, c)) for c in cameras)
    return -(-int(1.3 * worst) // cfg.chunk_size) * cfg.chunk_size


def phase_parity() -> None:
    import jax
    import jax.numpy as jnp
    from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu.render import binning, tile_raster
    from gaussian_splat_ipu_tpu.render.kernels import rasterize
    from gaussian_splat_ipu_tpu.render.oracle import render_oracle
    from gaussian_splat_ipu_tpu.render.pipeline import render
    from gaussian_splat_ipu_tpu.render.projection import project_gaussians
    from gaussian_splat_ipu_tpu.utils.config import RasterConfig

    bb = np.ones(3, np.float32)
    cam = orbit(-bb, bb, 30.0)
    model = GaussianModel.random(jax.random.PRNGKey(0), N_PARITY,
                                 extent=1.0)
    for g in (1, 3):
        cfg = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                           pair_capacity=1 << 19, tile_group=g,
                           exact_tile_test=True)
        b = jax.jit(lambda m: binning.bin_splats(
            project_gaussians(m, cam, cfg), cfg))(model)  # noqa: B023
        check(int(b.overflow) == 0, f"parity scene overflow at g={g}")
        spec = np.asarray(jax.jit(
            lambda b: tile_raster.rasterize_tiles_jnp(b, cfg))(b))  # noqa
        got = np.asarray(jax.jit(
            lambda b: rasterize.rasterize_tiles(b, cfg))(b))  # noqa: B023
        err = float(np.abs(got - spec).max())
        say(f"phase 1: forward g={g}, {int(b.num_pairs)} pairs: "
            f"max|kernel - spec| {err:.3e} (tolerance {FWD_ATOL:.0e})")
        check(err <= FWD_ATOL, f"forward parity at g={g}")

        cot = jax.random.normal(jax.random.PRNGKey(7), spec.shape,
                                jnp.float32)

        def grad(raster):
            return jax.jit(jax.grad(lambda f: jnp.sum(
                raster(b._replace(features=f), cfg) * cot)))  # noqa: B023

        g_spec = np.asarray(grad(tile_raster.rasterize_tiles_jnp)(
            b.features))
        g_kern = np.asarray(grad(rasterize.rasterize_tiles)(b.features))
        err = np.abs(g_kern - g_spec)
        # Depth (the last feature row) has no gradient.
        rows = [float(err[r].max() / max(np.abs(g_spec[r]).max(), 1e-30))
                for r in range(binning.NUM_FEATURES - 1)]
        worst = int(np.argmax(rows))
        say(f"phase 1: gradient g={g}: max|err| / max|spec| per feature "
            f"row, worst row {worst}: {rows[worst]:.3e} (tolerance "
            f"{GRAD_RTOL:.0e})")
        check(np.isfinite(g_kern).all() and rows[worst] <= GRAD_RTOL,
              f"gradient parity at g={g}")

    small = RasterConfig(image_width=160, image_height=96,
                         pair_capacity=1 << 16, extent_sigma=0.0)
    sm = GaussianModel.random(jax.random.PRNGKey(3), 6000, extent=1.0)
    scam = orbit(-bb, bb, 30.0, aspect=160 / 96)
    ref = np.asarray(jax.jit(lambda m: render_oracle(m, scam, small))(sm))
    out = jax.jit(lambda m: render(m, scam, small, True))(sm)
    check(int(out.overflow) == 0 and int(out.truncated) == 0,
          "oracle scene overflow/truncation")
    err = float(np.abs(np.asarray(out.image) - ref).max())
    say(f"phase 1: pipeline vs dense oracle (6000 gaussians, 160x96): "
        f"max err {err:.3e} (tolerance {ORACLE_ATOL:.0e})")
    check(err <= ORACLE_ATOL, "oracle parity")


def phase_render(tmp: str, log) -> tuple:
    import jax
    from gaussian_splat_ipu_tpu.app import main as app_main
    from gaussian_splat_ipu_tpu.io.scene import load_scene
    from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu.render.pipeline import render
    from gaussian_splat_ipu_tpu.runtime import engine
    from gaussian_splat_ipu_tpu.train import checkpoint
    from gaussian_splat_ipu_tpu.utils import image as image_util
    from gaussian_splat_ipu_tpu.utils.config import RasterConfig

    ply = os.path.join(tmp, "scene_1m.ply")
    checkpoint.export_ply(ply, GaussianModel.random(
        jax.random.PRNGKey(0), N_MAIN, extent=1.0))
    png = os.path.join(tmp, "frame.png")
    frames = 16
    t0 = time.perf_counter()
    rc = app_main.main([
        "--input", ply, "--width", str(WIDTH), "--height", str(HEIGHT),
        "--frames", str(frames), "--tile-group", "3", "--exact-tiles",
        "--pair-capacity", "0", "--output", png, "--log-level", "warn"])
    say(f"phase 2: render app, {frames} frames of {N_MAIN} gaussians at "
        f"{WIDTH}x{HEIGHT}: rc {rc}, {time.perf_counter() - t0:.1f} s "
        "including the capacity probe and compiles")
    check(rc == 0, "render app exit code")
    with open(png, "rb") as f:
        img = image_util.decode_png(f.read())
    check(img.shape[:2] == (HEIGHT, WIDTH), f"PNG shape {img.shape}")
    check(int(img[..., :3].max()) > 0, "PNG has content")

    scene = load_scene(ply)
    cap = app_main._cached_pair_capacity(
        ply, scene, WIDTH, HEIGHT, float(np.radians(FOV_DEG)), True, 3,
        True, engine.compile_cache_dir(), log)
    cfg = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                       pair_capacity=cap, tile_group=3,
                       exact_tile_test=True)
    frame = jax.jit(lambda m, ry: render(
        m, orbit(scene.bb_min, scene.bb_max, ry), cfg, True))
    drops = [frame(scene.model, np.float32(360.0 * i / frames))
             for i in range(frames)]
    ovf = max(int(o.overflow) for o in drops)
    trunc = max(int(o.truncated) for o in drops)
    pairs = max(int(o.num_pairs) for o in drops)
    say(f"phase 2: pair capacity {cap}, worst frame {pairs} pairs, "
        f"overflow {ovf}, truncated {trunc}")
    check(ovf == 0 and trunc == 0, "render overflow/truncation")
    ms = median_ms(lambda m: frame(m, np.float32(45.0)).image,
                   scene.model, reps=16)
    say(f"phase 2: steady-state frame {ms:.3f} ms (median of 16, "
        "render() at the app's config)")
    return ply, scene, cap


def phase_train(tmp: str, ply: str, scene, cap: int) -> None:
    import jax
    from gaussian_splat_ipu_tpu.app import train as train_app
    from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu.render.pipeline import render, render_image
    from gaussian_splat_ipu_tpu.train import checkpoint, trainer
    from gaussian_splat_ipu_tpu.utils.config import RasterConfig

    # The app distils into a random model of the scene's size, drawn as
    # below; size the pair table for it and for the scene's target views.
    views = 8
    extent = float(np.linalg.norm(scene.bb_max - scene.bb_min) * 0.5)
    init = GaussianModel.random(jax.random.PRNGKey(0),
                                scene.num_gaussians, extent=extent)
    cams = [orbit(scene.bb_min, scene.bb_max, 360.0 * i / views)
            for i in range(views)]
    base = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                        tile_group=3, exact_tile_test=True)
    cap = max(cap, probe_capacity(init, cams, base))
    cfg = dataclasses.replace(base, pair_capacity=cap)
    out = jax.jit(lambda m, c: render(m, c, cfg, True))
    for m in (init, scene.model):
        drops = [out(m, c) for c in cams]
        check(max(int(o.overflow) + int(o.truncated) for o in drops) == 0,
              "train views overflow/truncation")

    trained = os.path.join(tmp, "trained.ply")
    steps = 5
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_app.main([
            "--input", ply, "--steps", str(steps), "--views", str(views),
            "--width", str(WIDTH), "--height", str(HEIGHT),
            "--tile-group", "3", "--exact-tiles", "--pair-capacity",
            str(cap), "--export-ply", trained, "--log-level", "warn"])
    dt = time.perf_counter() - t0
    m = re.search(r"final_loss=(\S+)", buf.getvalue())
    loss = float(m.group(1)) if m else float("nan")
    say(f"phase 3: train app, {steps} steps at {WIDTH}x{HEIGHT}, pair "
        f"capacity {cap}: rc {rc}, final loss {loss:.6f}, {dt:.1f} s "
        "including target renders and compiles")
    check(rc == 0 and np.isfinite(loss), "train app loss")
    after = checkpoint.import_ply(trained)
    moved = float(np.abs(np.asarray(after.means)
                         - np.asarray(init.means)).max())
    finite = all(np.isfinite(np.asarray(x)).all()
                 for x in jax.tree_util.tree_leaves(after))
    say(f"phase 3: parameters finite {finite}, max |mean moved| "
        f"{moved:.3e}")
    check(finite and moved > 0.0, "trained parameters changed")

    tc = trainer.TrainConfig(scene_extent=extent)
    target = jax.jit(render_image, static_argnums=(2, 3))(
        scene.model, cams[0], cfg, True)
    step = jax.jit(lambda s: trainer.train_step(s, cams[0], target, cfg,
                                                tc, True))
    state = trainer.init_state(init, tc)
    ms = median_ms(step, state, reps=5)
    say(f"phase 3: steady-state train step {ms:.3f} ms (median of 5, "
        "trainer.train_step at the app's config)")


def _diff(a, b, rows_are: str = "pixels") -> str:
    """Max and mean |a - b|, and how many rows of the last axis (pixels,
    splats) differ at all; NaN equals NaN."""
    a, b = np.asarray(a), np.asarray(b)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    delta = np.where(same, 0.0, np.abs(a - b))
    rows = np.logical_not(same.all(axis=-1))
    return (f"max |diff| {float(np.nanmax(delta)):.3e}, mean "
            f"{float(np.nanmean(delta)):.3e}, {int(rows.sum())} of "
            f"{rows.size} {rows_are} differ")


def phase_multi(count: int) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu.parallel import distributed
    from gaussian_splat_ipu_tpu.parallel import mesh as mesh_lib
    from gaussian_splat_ipu_tpu.render.pipeline import (render, render_image,
                                                        render_splats)
    from gaussian_splat_ipu_tpu.render.projection import project_gaussians
    from gaussian_splat_ipu_tpu.train import trainer
    from gaussian_splat_ipu_tpu.utils.config import RasterConfig

    check(len(jax.devices()) >= count,
          f"--multi {count} needs {count} GPUs, JAX sees "
          f"{len(jax.devices())}")
    bb = np.ones(3, np.float32)
    model = GaussianModel.random(jax.random.PRNGKey(0), N_MAIN, extent=1.0)
    cams = [orbit(-bb, bb, ry) for ry in (0.0, 45.0)]
    base = RasterConfig(image_width=WIDTH, image_height=HEIGHT,
                        tile_group=3, exact_tile_test=True)
    cfg = dataclasses.replace(base, pair_capacity=probe_capacity(
        model, cams, base))
    mesh = mesh_lib.make_mesh(count)
    xcap = 2 * -(-N_MAIN // count)

    def drops(out):
        return (int(out.overflow), int(out.truncated),
                int(out.exchange_overflow))

    def same(a, b) -> bool:
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)

    # End to end, the camera an argument of both programs, as in the apps.
    shard_model = mesh_lib.shard_model(model, mesh)
    single = jax.jit(lambda m, c: render(m, c, cfg, True).image)(
        model, cams[0])
    out = jax.jit(lambda m, c: distributed.render_sharded(
        m, c, cfg, mesh, pair_capacity=cfg.pair_capacity,
        exchange_capacity=xcap))(shard_model, cams[0])
    e2e = (drops(out), same(out.image, single))
    say(f"phase 4: render_sharded on {count} GPUs vs render on one: "
        f"{_diff(out.image, single)}; drops (overflow, truncated, "
        f"exchange) {drops(out)}")

    # From the same projected splats (exchange, strip binning, rasterize).
    project = jax.jit(lambda m, c: project_gaussians(m, c, cfg))
    splats = project(model, cams[0])
    ref = jax.jit(lambda s: render_splats(s, cfg, True).image)(splats)
    on_mesh = NamedSharding(mesh, P(mesh_lib.SHARD_AXIS))
    out = jax.jit(lambda s: distributed.render_splats_sharded(
        s, cfg, mesh, pair_capacity=cfg.pair_capacity,
        exchange_capacity=xcap))(jax.device_put(splats, on_mesh))
    from_splats = (drops(out), same(out.image, ref))
    say(f"phase 4: from the same projected splats, render_splats_sharded "
        f"vs render_splats: {_diff(out.image, ref)}; drops {drops(out)}")
    flat = [np.concatenate([np.asarray(x).reshape(N_MAIN, -1)
                            for x in sp], axis=-1)
            for sp in (splats, project(shard_model, cams[0]))]
    say(f"phase 4: projection on one GPU vs sharded over {count}: "
        f"{_diff(flat[1], flat[0], 'splats')}")

    # The same two renders with the camera baked into each program as a
    # constant: the single-GPU program then rounds the camera arithmetic
    # differently (most likely folded at compile time), so it is not
    # bit-identical to either render above; printed, not checked.
    baked = jax.jit(lambda m: render(m, cams[0], cfg, True).image)(model)
    out = jax.jit(lambda m: distributed.render_sharded(
        m, cams[0], cfg, mesh, pair_capacity=cfg.pair_capacity,
        exchange_capacity=xcap))(shard_model)
    say(f"phase 4: camera as a constant, render vs the camera as an "
        f"argument: {_diff(baked, single)}; render_sharded vs render, both "
        f"with the constant: {_diff(out.image, baked)}")
    check(e2e == ((0, 0, 0), True),
          "sharded render bit-identical to the single-GPU one")
    check(from_splats == ((0, 0, 0), True),
          "sharded render of the same splats bit-identical")

    mesh2 = mesh_lib.make_mesh_2d(num_views=2, num_shards=count // 2)
    tc = trainer.TrainConfig(ssim_weight=0.0)
    state = trainer.init_state(mesh_lib.shard_model(model, mesh2), tc)
    cam_b = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    targets = jnp.stack([jax.jit(render_image, static_argnums=(2, 3))(
        model, c, cfg, True) for c in cams]) * 0.5
    step = distributed.make_view_batch_train_step(mesh2, cfg, tc)
    state, loss, stats = step(state, cam_b, targets)
    loss = float(loss)
    stats = {k: int(v) for k, v in stats.items()}
    say(f"phase 4: view-batch train step on a (2 views x {count // 2} "
        f"shards) mesh: loss {loss:.6f}, drops {stats}")
    check(np.isfinite(loss) and not any(stats.values()),
          "view-batch train step")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="GPU smoke run")
    p.add_argument("--multi", type=int, default=0, metavar="N",
                   help="run only the N-GPU phase (N = 4)")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX sees {devices}")
    from gaussian_splat_ipu_tpu.runtime import engine

    engine.setup_logging("warn")
    log = logging.getLogger("gsplat")
    engine.enable_compilation_cache()
    say(f"phase 0: {len(devices)} x {devices[0].device_kind}, "
        f"JAX {jax.__version__}")
    t_all = time.perf_counter()
    if args.multi:
        phase_multi(args.multi)
        used = devices[:args.multi]
    else:
        with jax.default_matmul_precision("highest"):
            phase_parity()
        with tempfile.TemporaryDirectory() as tmp:
            ply, scene, cap = phase_render(tmp, log)
            phase_train(tmp, ply, scene, cap)
        used = devices[:1]
    say(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    say(card())
    print(result_line(used), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
