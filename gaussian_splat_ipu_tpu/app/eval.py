"""Evaluation CLI: render a trained scene against posed images and report
PSNR / SSIM per view.

The reference has no evaluation tooling at all (it is a forward-only
viewer, /root/reference/src/main/splat.cpp); this closes the loop for the
training extension: `app/train.py --export-ply scene.ply` produces the
standard 3DGS artifact, and this CLI scores it on a dataset's held-out
views the way every 3DGS implementation reports quality (mean PSNR/SSIM
over a holdout of every K-th frame, the Mip-NeRF360 convention).

Usage:
    python -m gaussian_splat_ipu_tpu.app.eval \
        --input trained.ply --dataset data/lego \
        --split holdout --holdout-every 8 --dump renders/

Prints one line per view plus a final machine-readable JSON summary.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

log = logging.getLogger("gsplat")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gsplat-eval", description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True,
                   help="trained 3DGS PLY (app/train.py --export-ply)")
    p.add_argument("--dataset", required=True,
                   help="transforms.json file or its directory; a sibling "
                        "transforms_test.json is preferred when present")
    p.add_argument("--split", default="holdout",
                   choices=["holdout", "train", "all"],
                   help="holdout = every K-th view (test), train = the "
                        "complement, all = every view")
    p.add_argument("--holdout-every", type=int, default=8,
                   help="K for the holdout split (Mip-NeRF360 convention)")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--pair-capacity", type=int, default=1 << 19)
    p.add_argument("--exact-tiles", action="store_true",
                   help="exact tile-ellipse coverage test (fewer pairs)")
    p.add_argument("--tile-group", type=int, default=1,
                   help="bin pairs over KxK super-tiles (composes with "
                        "--exact-tiles)")
    p.add_argument("--antialias", action="store_true",
                   help="energy-conserving lowpass — match a scene "
                        "trained with --antialias")
    p.add_argument("--background", default="black",
                   choices=["black", "white"],
                   help="composite both render and RGBA targets over this")
    p.add_argument("--dump", default="",
                   help="directory for per-view rendered PNGs")
    p.add_argument("--dump-depth", action="store_true",
                   help="with --dump: also write normalised depth maps "
                        "(render_depth: alpha-composited mean depth)")
    p.add_argument("--device", default="pallas",
                   choices=["pallas", "jnp", "points"],
                   help="render path (pallas = the rasterizer kernels, "
                        "compiled on the GPU, interpreted on the CPU)")
    p.add_argument("--log-level", default="info")
    return p


def select_split(n: int, split: str, k: int):
    """Frame indices for a split. holdout = {0, k, 2k, ...}."""
    if split == "all":
        return list(range(n))
    hold = set(range(0, n, max(k, 1)))
    if split == "holdout":
        return sorted(hold)
    return [i for i in range(n) if i not in hold]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp

    from gaussian_splat_ipu_tpu.io import dataset as dataset_lib
    from gaussian_splat_ipu_tpu.render import pipeline
    from gaussian_splat_ipu_tpu.render import points as points_render
    from gaussian_splat_ipu_tpu.train import checkpoint, losses
    from gaussian_splat_ipu_tpu.utils import image as image_util
    from gaussian_splat_ipu_tpu.utils.config import RasterConfig
    from gaussian_splat_ipu_tpu.runtime.engine import setup_logging

    setup_logging(args.log_level)

    # A transforms_test.json next to the train json wins for eval — that
    # IS the test split, no index games needed (NeRF-synthetic layout).
    ds_path = args.dataset
    if os.path.isdir(ds_path):
        test_json = os.path.join(ds_path, "transforms_test.json")
        if os.path.exists(test_json) and args.split != "train":
            ds_path = test_json
            args.split = "all"
    from gaussian_splat_ipu_tpu.io import colmap as colmap_lib
    if os.path.isdir(ds_path) and colmap_lib.is_colmap_dir(ds_path):
        fs, _, _ = colmap_lib.load_colmap(ds_path,
                                          downscale=args.downscale,
                                          max_frames=args.max_frames)
    else:
        fs = dataset_lib.load_transforms(ds_path,
                                         downscale=args.downscale,
                                         max_frames=args.max_frames)
    idxs = select_split(len(fs), args.split, args.holdout_every)
    if not idxs:
        raise SystemExit("split selected zero views")

    model = checkpoint.import_ply(args.input)
    cfg = RasterConfig(image_width=fs.width, image_height=fs.height,
                       pair_capacity=args.pair_capacity,
                       exact_tile_test=args.exact_tiles,
                       tile_group=args.tile_group,
                       antialias=args.antialias)
    log.info("eval: %d gaussians, %d/%d views (%s), %dx%d",
             model.num_gaussians, len(idxs), len(fs), args.split,
             fs.width, fs.height)

    bg = 1.0 if args.background == "white" else 0.0

    if args.device == "points":
        def render_rgb(cam):
            img = points_render.render_points(model, cam, cfg).image
            return jnp.asarray(img)[..., :3]
    else:
        use_pallas = args.device == "pallas"

        @jax.jit
        def render_rgb(cam):
            img = pipeline.render_image(model, cam, cfg, use_pallas)
            # Renders are alpha-composited over transparent; put them on
            # the same background as the targets for a fair comparison.
            return img[..., :3] + bg * (1.0 - img[..., 3:4])

    if args.dump:
        os.makedirs(args.dump, exist_ok=True)

    rows = []
    for i in idxs:
        target = np.asarray(fs.images[i], np.float32)
        if target.shape[-1] == 4:  # RGBA target: composite over bg
            a = target[..., 3:4]
            target = target[..., :3] * a + bg * (1.0 - a)
        pred = np.asarray(render_rgb(fs.cameras[i]))
        p = float(losses.psnr(jnp.asarray(pred), jnp.asarray(target)))
        s = float(losses.ssim(jnp.asarray(pred), jnp.asarray(target)))
        rows.append((i, p, s))
        log.info("view %4d: psnr %6.2f dB  ssim %.4f", i, p, s)
        if args.dump:
            image_util.write_png(
                os.path.join(args.dump, f"eval_{i:05d}.png"), pred)
            if args.dump_depth and args.device != "points":
                mean_d, _, a = jax.jit(
                    pipeline.render_depth, static_argnums=(2, 3))(
                    model, fs.cameras[i], cfg, args.device == "pallas")
                d = np.asarray(mean_d)
                hi_d = np.percentile(d[np.asarray(a) > 0.5], 99.0) \
                    if float(np.asarray(a).max()) > 0.5 else 1.0
                image_util.write_png(
                    os.path.join(args.dump, f"depth_{i:05d}.png"),
                    np.clip(d / max(hi_d, 1e-6), 0.0, 1.0))

    mean_psnr = float(np.mean([r[1] for r in rows]))
    mean_ssim = float(np.mean([r[2] for r in rows]))
    print(json.dumps({
        "views": len(rows), "split": args.split,
        "mean_psnr": round(mean_psnr, 4), "mean_ssim": round(mean_ssim, 6),
        "min_psnr": round(min(r[1] for r in rows), 4),
        "gaussians": model.num_gaussians,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
