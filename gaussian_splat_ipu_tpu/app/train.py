"""Training application: fit gaussian parameters to target views.

The reference has no training capability (forward-only render server); this
implements BASELINE.json config 4 — a full training-style iteration loop on
a real scene, device-resident — as a CLI:

    python -m gaussian_splat_ipu_tpu.app.train --input scene.ply \
        --steps 200 --views 8 [--distill | --self]

Two target modes:
  --distill  render target views from the LOADED scene, then train a
             fresh random initialisation toward them (a full end-to-end
             optimisation demo with known ground truth; reports PSNR).
  --self     start from the loaded parameters and keep optimising against
             its own renders (a fast smoke of the update path).

Targets are rendered once up front and stay on device; each step is one
jitted fwd+bwd+Adam program.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import numpy as np

log = logging.getLogger("gsplat")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Gaussian splat trainer")
    p.add_argument("--input", default="", help="PLY/XYZ scene")
    p.add_argument("--dataset", default="",
                   help="transforms.json dataset (NeRF-synthetic / "
                        "nerfstudio): train on its posed images instead "
                        "of distilling a loaded scene")
    p.add_argument("--downscale", type=int, default=1,
                   help="--dataset: image downscale factor")
    p.add_argument("--holdout-every", type=int, default=0,
                   help="--dataset: hold every K-th view out of training "
                        "and report eval PSNR on the holdout at the end "
                        "(0 = train on all views)")
    p.add_argument("--log-level", default="info")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--views", type=int, default=8,
                   help="orbit camera count for the target set")
    p.add_argument("--init-gaussians", type=int, default=0,
                   help="--distill: random-init size (0 = same as scene)")
    p.add_argument("--mode", choices=["distill", "self"],
                   default="distill")
    p.add_argument("--ssim-weight", type=float, default=0.2)
    p.add_argument("--sh-degree", type=int, default=-1,
                   help="SH capacity for random-init models (-1 = keep "
                        "the source degree; new bands start at zero)")
    p.add_argument("--sh-step-every", type=int, default=0,
                   help="progressive SH schedule: activate one more band "
                        "every N steps (3DGS uses 1000; 0 = all bands "
                        "from the start). Each bump recompiles once.")
    p.add_argument("--pose-opt", type=float, default=0.0, metavar="LR",
                   help="jointly refine per-view camera poses (SE(3) "
                        "tangent deltas at this Adam LR; 5e-4 is a "
                        "sensible start). Single-device, non-densify "
                        "paths only; composes with --exposure-opt and "
                        "--depth-loss")
    p.add_argument("--exposure-opt", type=float, default=0.0,
                   metavar="LR",
                   help="per-view affine exposure compensation applied "
                        "to the render before the loss (Adam LR; 1e-2 "
                        "is a sensible start). Single-device, "
                        "non-densify paths; composes with --pose-opt "
                        "and --depth-loss")
    p.add_argument("--depth-loss", type=float, default=0.0, metavar="W",
                   help="supervise rendered depth at the COLMAP SfM "
                        "track observations with this weight (masked "
                        "relative-L1; needs a COLMAP --dataset; "
                        "single-device paths, composes with --densify "
                        "and with --pose-opt/--exposure-opt)")
    p.add_argument("--shuffle", action="store_true",
                   help="visit training views in a fresh random order "
                        "each epoch (standard 3DGS camera sampling); "
                        "ignored with --view-batch")
    p.add_argument("--background", choices=["black", "white"],
                   default="black",
                   help="render/composite background (standard 3DGS "
                        "trains NeRF-synthetic over white)")
    p.add_argument("--max-device-views", type=int, default=0,
                   help="stream training targets from host RAM in "
                        "chunks of this many views per epoch-scan "
                        "program (0 = keep the whole target stack "
                        "device-resident). Bounds HBM at full-res "
                        "many-view captures; non-divisible view counts "
                        "wrap a few duplicates into the last chunk")
    p.add_argument("--pair-capacity", type=int, default=1 << 18)
    p.add_argument("--exact-tiles", action="store_true",
                   help="exact tile-ellipse coverage test (fewer pairs, "
                        "identical image)")
    p.add_argument("--tile-group", type=int, default=1,
                   help="bin pairs over KxK super-tiles (GS-TG-style "
                        "sort reduction; composes with --exact-tiles; "
                        "with --distributed, rows-per-device must be a "
                        "multiple of K)")
    p.add_argument("--antialias", action="store_true",
                   help="energy-conserving lowpass (Mip-Splatting)")
    p.add_argument("--checkpoint", default="",
                   help="write final params + opt state here (.npz); "
                        "with --densify the density-control state is "
                        "included")
    p.add_argument("--resume", default="",
                   help="restore a --checkpoint .npz (same CLI shape "
                        "flags) and continue training from it")
    p.add_argument("--export-ply", default="",
                   help="write trained scene as standard 3DGS PLY")
    p.add_argument("--export-splat", default="",
                   help="write trained scene as a web-viewer .splat "
                        "(antimatter15 format; u8-quantised)")
    p.add_argument("--distributed", action="store_true",
                   help="shard over all local devices (parallel/)")
    p.add_argument("--view-batch", type=int, default=0,
                   help="--distributed: ALSO data-parallelise over camera "
                        "views on a 2D (view, shard) mesh — each step "
                        "consumes this many views at once (device count "
                        "must be divisible by it)")
    p.add_argument("--densify", action="store_true",
                   help="adaptive density control (split/clone/prune)")
    p.add_argument("--capacity", type=int, default=0,
                   help="--densify: slot-buffer capacity (0 = 2x init)")
    p.add_argument("--densify-every", type=int, default=100)
    p.add_argument("--densify-grad-threshold", type=float, default=2e-4)
    p.add_argument("--densify-from", type=int, default=500)
    p.add_argument("--densify-until", type=int, default=15_000)
    p.add_argument("--auto-grow", action="store_true",
                   help="--densify: double the slot-buffer capacity when "
                        "90%% full (one recompile per growth) instead of "
                        "dropping lowest-priority births")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from gaussian_splat_ipu_tpu.runtime import engine as engine_lib
    engine_lib.setup_logging(args.log_level)
    engine_lib.enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from gaussian_splat_ipu_tpu.io.scene import load_scene
    from gaussian_splat_ipu_tpu.models.camera import Camera
    from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu.parallel import multihost
    from gaussian_splat_ipu_tpu.render.pipeline import render_image
    from gaussian_splat_ipu_tpu.train import checkpoint, losses, trainer
    from gaussian_splat_ipu_tpu.utils.config import RasterConfig

    if not args.input and not args.dataset:
        raise SystemExit("one of --input / --dataset is required")
    # --tile-group composes with --distributed when each device's row
    # strip covers whole group rows; binning raises a clear ValueError
    # otherwise (rows-per-device % group != 0).

    # Multi-process bootstrap (GSPLAT_COORDINATOR env; no-op without it):
    # after this, jax.devices() spans every host and the same code below
    # runs as one SPMD program per the multi-controller contract.
    multihost.initialize()
    multiproc = jax.process_count() > 1
    mesh = None
    if multiproc and args.distributed:
        from gaussian_splat_ipu_tpu.parallel import mesh as meshlib
        mesh = meshlib.make_mesh()
        log.info("multi-process run: %d processes, %d global devices",
                 jax.process_count(), len(jax.devices()))

    render_jit = jax.jit(render_image, static_argnums=(2, 3))
    holdout_cams, holdout_targets = [], []
    if args.dataset:
        # Real posed images: cameras + targets come from the dataset; the
        # model seeds from the COLMAP SfM points when present (standard
        # 3DGS init), else random init inside the camera bounding sphere.
        from gaussian_splat_ipu_tpu.io import colmap as colmap_lib
        from gaussian_splat_ipu_tpu.io import dataset as dataset_lib
        sfm_xyz = sfm_rgb = None
        depth_obs = None
        if (os.path.isdir(args.dataset)
                and colmap_lib.is_colmap_dir(args.dataset)):
            if args.depth_loss > 0:
                fs, sfm_xyz, sfm_rgb, depth_obs = colmap_lib.load_colmap(
                    args.dataset, downscale=args.downscale,
                    with_depth=True)
            else:
                fs, sfm_xyz, sfm_rgb = colmap_lib.load_colmap(
                    args.dataset, downscale=args.downscale)
        else:
            if args.depth_loss > 0:
                log.warning("--depth-loss needs a COLMAP dataset "
                            "(SfM track observations); ignoring")
                args.depth_loss = 0.0
            fs = dataset_lib.load_transforms(args.dataset,
                                             downscale=args.downscale)
        bg = 1.0 if args.background == "white" else 0.0

        def as_target(im):
            """RGBA datasets (NeRF-synthetic) carry straight alpha; the
            renderer composites over cfg.background, so flatten the
            target over the SAME background before the loss / PSNR
            compares the RGB channels (eval.py does the same)."""
            im = np.asarray(im, np.float32)
            if im.shape[-1] == 4:
                im = im[..., :3] * im[..., 3:4] + bg * (1.0 - im[..., 3:4])
            return im

        holdout_cams, holdout_targets = [], []
        if args.holdout_every > 0:
            from gaussian_splat_ipu_tpu.app import eval as eval_app
            hold = eval_app.select_split(len(fs), "holdout",
                                         args.holdout_every)
            train_idx = [i for i in range(len(fs)) if i not in set(hold)]
            holdout_cams = [fs.cameras[i] for i in hold]
            holdout_targets = [as_target(fs.images[i]) for i in hold]
            log.info("holdout: %d eval views (every %d), %d train views",
                     len(hold), args.holdout_every, len(train_idx))
        else:
            train_idx = list(range(len(fs)))
        cameras = [fs.cameras[i] for i in train_idx]
        # Host numpy: the epoch programs receive targets as call
        # arguments, so the full stack only moves to HBM when
        # --max-device-views is off (see targets_src below).
        targets = [as_target(fs.images[i]) for i in train_idx]
        depth_pack = None
        if args.depth_loss > 0 and depth_obs is not None:
            from gaussian_splat_ipu_tpu.train import depth as depth_mod
            depth_pack = depth_mod.pack_observations(
                [depth_obs[i] for i in train_idx])
            total_obs = sum(depth_obs[i].shape[0] for i in train_idx)
            log.info("depth supervision: %d SfM observations over %d "
                     "views (packed K=%d)", total_obs, len(train_idx),
                     depth_pack[0].shape[1])
        args.views = len(cameras)
        args.width, args.height = fs.width, fs.height
        cfg = RasterConfig(image_width=fs.width, image_height=fs.height,
                           pair_capacity=args.pair_capacity,
                           exact_tile_test=args.exact_tiles,
                           antialias=args.antialias,
                           tile_group=args.tile_group,
                           background=(bg, bg, bg))
        origins = np.stack([np.asarray(c.cam_origin) for c in cameras])
        center = origins.mean(0)
        extent = float(np.linalg.norm(origins - center, axis=1).max())
        extent = max(extent, 1e-3)
        if sfm_xyz is not None and sfm_xyz.shape[0] > 0:
            # Standard 3DGS seeds at full SH capacity (degree 3, f_rest
            # zeros) so view-dependent colour can train; --sh-degree
            # overrides, --sh-step-every gates activation.
            deg = args.sh_degree if args.sh_degree >= 0 else 3
            model = GaussianModel.from_points(sfm_xyz, sfm_rgb,
                                              sh_degree=deg)
            log.info("init from %d COLMAP SfM points (SH degree %d)",
                     sfm_xyz.shape[0], deg)
        else:
            n = args.init_gaussians or 20_000
            model = GaussianModel.random(jax.random.PRNGKey(0), n,
                                         extent=0.5 * extent)
        log.info("dataset %s: %d views at %dx%d, camera extent %.2f",
                 args.dataset, len(cameras), fs.width, fs.height, extent)
    else:
        depth_pack = None
        if args.depth_loss > 0:
            log.warning("--depth-loss needs a COLMAP --dataset; ignoring")
            args.depth_loss = 0.0
        if mesh is not None:
            # Each process parses ONLY its slice of the scene file and the
            # model assembles directly as one globally-sharded jax.Array
            # (north-star config 5 loading story).
            scene = multihost.load_scene_sharded(args.input, mesh)
        else:
            scene = load_scene(args.input)
        bg = 1.0 if args.background == "white" else 0.0
        cfg = RasterConfig(image_width=args.width,
                           image_height=args.height,
                           pair_capacity=args.pair_capacity,
                           exact_tile_test=args.exact_tiles,
                           antialias=args.antialias,
                           tile_group=args.tile_group,
                           background=(bg, bg, bg))
        fov = float(np.radians(40.0))
        aspect = args.width / args.height
        extent = float(np.linalg.norm(scene.bb_max - scene.bb_min) * 0.5)

        cameras = [Camera.orbit(scene.bb_min, scene.bb_max, fov, aspect,
                                rot_y_deg=360.0 * i / args.views)
                   for i in range(args.views)]

        log.info("rendering %d target views at %dx%d from %d gaussians",
                 args.views, args.width, args.height, scene.num_gaussians)
        targets = [render_jit(scene.model, cam, cfg, True)
                   for cam in cameras]

        if args.mode == "distill":
            n = args.init_gaussians or scene.num_gaussians
            model = GaussianModel.random(jax.random.PRNGKey(0), n,
                                         extent=extent)
        else:
            model = scene.model

    if args.sh_degree >= 0 and args.sh_degree != model.sh_degree:
        if mesh is not None and args.input:
            log.warning("--sh-degree ignored: scene was loaded sharded")
        else:
            model = model.with_sh_degree(args.sh_degree)
            log.info("SH degree -> %d (%d bands)", args.sh_degree,
                     model.sh.shape[1])
    # Progressive SH: start at band 0 and raise by one every
    # --sh-step-every steps (static config -> one recompile per bump).
    full_sh_degree = model.sh_degree
    active_sh = 0 if args.sh_step_every > 0 else -1

    tc = trainer.TrainConfig(ssim_weight=args.ssim_weight,
                             scene_extent=extent)
    use_dist = args.distributed and len(jax.devices()) > 1
    if args.view_batch > 1 and (not use_dist or args.densify
                                or multiproc):
        log.warning("--view-batch needs --distributed without --densify "
                    "in a single process; ignoring")
        args.view_batch = 0
    if args.view_batch > 1 and len(jax.devices()) % args.view_batch:
        raise SystemExit("--view-batch must divide the device count "
                         f"({len(jax.devices())})")
    dstate = None
    austate = None
    # --pose-opt / --exposure-opt / --depth-loss COMPOSE on the
    # single-device non-densify path (one aux_opt step program carries
    # every active module; train/aux_opt.py). Depth additionally composes
    # with --densify (depth-regularised density control).
    for flag in ("pose_opt", "exposure_opt"):
        if getattr(args, flag) > 0 and (args.densify or use_dist
                                        or multiproc):
            log.warning("--%s needs the single-device non-densify "
                        "path; ignoring", flag.replace("_", "-"))
            setattr(args, flag, 0.0)
    if args.depth_loss > 0 and (use_dist or multiproc):
        log.warning("--depth-loss needs the single-device path; ignoring")
        args.depth_loss = 0.0
    if args.pose_opt > 0 or args.exposure_opt > 0:
        from gaussian_splat_ipu_tpu.train import aux_opt as aux_lib
        austate = aux_lib.init_aux_state(args.views, args.pose_opt,
                                         args.exposure_opt)
        if args.pose_opt > 0:
            log.info("pose refinement on: %d views, lr %g", args.views,
                     args.pose_opt)
        if args.exposure_opt > 0:
            log.info("exposure compensation on: %d views, lr %g",
                     args.views, args.exposure_opt)

    def ensure_sharded(m, mesh_):
        from gaussian_splat_ipu_tpu.parallel import mesh as meshlib
        already = all(
            isinstance(x, jax.Array) and len(x.sharding.device_set) > 1
            for x in jax.tree.leaves(m))
        return m if already else meshlib.shard_model(m, mesh_)
    if args.densify:
        from gaussian_splat_ipu_tpu.train import densify as densify_lib
        n0 = model.num_gaussians
        capacity = args.capacity or 2 * n0
        if args.distributed:
            # Sharded slot buffers must divide evenly over the mesh:
            # shard_model would otherwise pad params past `capacity`
            # while dstate stays at `capacity` (shape desync).
            d_all = len(jax.devices())
            capacity = -(-capacity // d_all) * d_all
        gscale = 1.0
        if args.ssim_weight > 0.0:
            # L1-calibrated threshold, SSIM-weighted loss: normalise by
            # the measured gradient scale of the mix or densification
            # over-grows (train/densify.py::loss_mix_scale).
            gscale = densify_lib.loss_mix_scale(
                model, cameras[0], targets[0], cfg, args.ssim_weight)
            log.info("densify threshold scaled x%.2f for ssim_weight "
                     "%.2f", gscale, args.ssim_weight)
        dcfg = densify_lib.DensifyConfig(
            grad_threshold=args.densify_grad_threshold * gscale,
            densify_every=max(args.densify_every // args.views, 1)
            * args.views,  # events land on epoch boundaries
            densify_from_step=args.densify_from,
            densify_until_step=args.densify_until,
            scene_extent=extent)
        dstate = densify_lib.init_state(n0, capacity)
        state = trainer.init_state(densify_lib.pad_model(model, capacity),
                                   tc)
        if use_dist:
            # Slot-buffer density control on the sharded trainer: the
            # probe grads land shard-local, surgery runs on sharded state
            # under jit (tests/test_densify_distributed.py).
            from gaussian_splat_ipu_tpu.parallel import (distributed,
                                                         mesh as meshlib)
            if mesh is None:
                mesh = meshlib.make_mesh()
            state = trainer.TrainState(
                params=ensure_sharded(state.params, mesh),
                opt_state=state.opt_state, step=state.step)
            log.info("distributed density control over %d devices",
                     len(jax.devices()))
        log.info("density control on: %d init gaussians, capacity %d",
                 n0, capacity)
    elif use_dist:
        from gaussian_splat_ipu_tpu.parallel import (distributed,
                                                     mesh as meshlib)
        if mesh is None:
            if args.view_batch > 1:
                # 2D (view, shard) mesh: camera-batch data parallelism on
                # the outer axis, gaussian/tile-row sharding inner.
                mesh = meshlib.make_mesh_2d(
                    num_views=args.view_batch,
                    num_shards=len(jax.devices()) // args.view_batch)
            else:
                mesh = meshlib.make_mesh()
        model = ensure_sharded(model, mesh)
        state = trainer.init_state(model, tc)
        log.info("distributed over %d devices%s", len(jax.devices()),
                 f" (view batch {args.view_batch})"
                 if args.view_batch > 1 else "")
    else:
        state = trainer.init_state(model, tc)

    # Chain whole view-epochs into one device program (lax.scan over the
    # stacked view set): one dispatch per epoch instead of one per step.
    cams_stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *cameras)
    chunk_views = (args.max_device_views
                   if 0 < args.max_device_views < args.views else 0)
    if chunk_views:
        # Host-resident target store: each epoch-scan call receives one
        # chunk_views-sized slice (uploaded on call), so device memory
        # holds only chunk + model + pairs instead of every view.
        targets_src = np.stack([np.asarray(t) for t in targets])
        log.info("target streaming: %d views on device per program "
                 "(%d total, %.1f MB host store)", chunk_views,
                 args.views, targets_src.nbytes / 1e6)
    else:
        targets_src = jnp.stack(targets)
    cam_treedef = jax.tree_util.tree_structure(cameras[0])
    cam_leaves_stacked = jax.tree_util.tree_leaves(cams_stacked)

    vb_groups = []
    if args.view_batch > 1:
        # Pre-stack camera/target groups (cycling to a batch multiple).
        idxs = list(range(args.views))
        idxs += idxs[:(-len(idxs)) % args.view_batch]
        for g in range(0, len(idxs), args.view_batch):
            sel = idxs[g:g + args.view_batch]
            gc = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *[cameras[k] for k in sel])
            gt = jnp.stack([targets[k] for k in sel])
            vb_groups.append((gc, gt))

    def build_programs(acfg):
        """Jitted epoch/step programs for one active-SH config. Rebuilt
        (one recompile each) whenever the progressive schedule bumps."""
        progs = {}
        if args.densify:
            with_depth = args.depth_loss > 0 and depth_pack is not None
            if use_dist:
                raw_step = distributed.make_sharded_densify_train_step(
                    mesh, acfg, tc, use_pallas=True, jit=False)
            else:
                raw_step = densify_lib.make_train_step(
                    acfg, tc, True, jit=False,
                    depth_weight=args.depth_loss if with_depth else 0.0)

            @jax.jit
            def epoch_densify(state, dstate, order, tgts):
                def body(carry, ct):
                    s, ds = carry
                    cam_leaves, tgt = ct[:2]
                    cam = jax.tree_util.tree_unflatten(cam_treedef,
                                                       cam_leaves)
                    s, ds, loss = raw_step(s, ds, cam, tgt, *ct[2:])
                    return (s, ds), loss
                xs = [[x[order] for x in cam_leaves_stacked], tgts]
                if with_depth:
                    obs_all, mask_all = depth_pack
                    xs += [obs_all[order], mask_all[order]]
                (s, ds), ls = jax.lax.scan(body, (state, dstate),
                                           tuple(xs))
                return s, ds, ls

            progs["epoch_densify"] = epoch_densify
        elif use_dist and args.view_batch > 1:
            progs["vb_step"] = distributed.make_view_batch_train_step(
                mesh, acfg, tc, pair_capacity=args.pair_capacity)
        elif use_dist:
            progs["step"] = distributed.make_sharded_train_step(
                mesh, acfg, tc, pair_capacity=args.pair_capacity)
        elif args.pose_opt > 0 or args.exposure_opt > 0:
            # COMPOSABLE per-view auxiliary optimisation: one aux_opt
            # step program over every active module (pose deltas,
            # exposure affines, sparse-depth residuals — any subset;
            # train/aux_opt.py).
            from gaussian_splat_ipu_tpu.train import aux_opt as aux_lib
            with_depth = args.depth_loss > 0 and depth_pack is not None
            raw_aux = aux_lib.make_aux_step(
                acfg, tc, pose_lr=args.pose_opt,
                exposure_lr=args.exposure_opt,
                depth_weight=args.depth_loss if with_depth else 0.0,
                use_pallas=True)
            dummy_obs, dummy_mask = aux_lib.dummy_depth_obs()
            if with_depth:
                aux_obs, aux_mask = depth_pack
            else:
                aux_obs = dummy_obs[None].repeat(args.views, 0)
                aux_mask = dummy_mask[None].repeat(args.views, 0)

            @jax.jit
            def epoch_aux(state, aux, order, tgts):
                def body(carry, ct):
                    s, a = carry
                    k, cam_leaves, tgt, ob, mk = ct
                    cam = jax.tree_util.tree_unflatten(cam_treedef,
                                                       cam_leaves)
                    s, a, loss = raw_aux(s, a, k, cam, tgt, ob, mk)
                    return (s, a), loss
                (s, a), ls = jax.lax.scan(
                    body, (state, aux),
                    (order, [x[order] for x in cam_leaves_stacked],
                     tgts, aux_obs[order], aux_mask[order]))
                return s, a, ls

            progs["epoch_aux"] = epoch_aux
            progs["step_aux"] = jax.jit(
                lambda s, a, k, c, t: raw_aux(s, a, k, c, t, aux_obs[k],
                                              aux_mask[k]))
        elif args.depth_loss > 0 and depth_pack is not None:
            from gaussian_splat_ipu_tpu.train import depth as depth_mod
            raw_dstep = depth_mod.make_depth_train_step(
                acfg, tc, args.depth_loss, use_pallas=True, jit=False)
            obs_all, mask_all = depth_pack

            @jax.jit
            def epoch_depth(state, order, tgts):
                def body(s, ct):
                    cam_leaves, tgt, ob, mk = ct
                    cam = jax.tree_util.tree_unflatten(cam_treedef,
                                                       cam_leaves)
                    return raw_dstep(s, cam, tgt, ob, mk)
                return jax.lax.scan(
                    body, state,
                    ([x[order] for x in cam_leaves_stacked], tgts,
                     obs_all[order], mask_all[order]))

            progs["epoch_depth"] = epoch_depth
            progs["step_depth"] = jax.jit(
                lambda s, k, c, t: raw_dstep(s, c, t, obs_all[k],
                                             mask_all[k]))
        else:
            progs["step"] = jax.jit(
                lambda s, c, t: trainer.train_step(s, c, t, acfg, tc,
                                                   True),
                donate_argnums=(0,))

            @jax.jit
            def epoch(state, order, tgts):
                def body(s, ct):
                    cam_leaves, tgt = ct
                    cam = jax.tree_util.tree_unflatten(cam_treedef,
                                                       cam_leaves)
                    return trainer.train_step(s, cam, tgt, acfg, tc, True)
                return jax.lax.scan(
                    body, state,
                    ([x[order] for x in cam_leaves_stacked], tgts))

            progs["epoch"] = epoch
        return progs

    def active_cfg():
        return (cfg if active_sh < 0 else
                dataclasses.replace(cfg, active_sh_degree=active_sh))

    if args.resume:
        if multiproc:
            raise SystemExit("--resume is single-process only (restore "
                             "then re-shard the file across hosts "
                             "manually via load_scene_sharded)")
        if args.densify:
            state, dstate = checkpoint.restore_checkpoint(
                args.resume, (state, dstate))
        elif austate is not None:
            # Leaf-count compatible with pre-composition checkpoints:
            # AuxState's None modules contribute no leaves, so an old
            # pose-only (state, PoseState) file restores into
            # (state, AuxState(pose, None)) unchanged.
            state, austate = checkpoint.restore_checkpoint(
                args.resume, (state, austate))
        else:
            state = checkpoint.restore_checkpoint(args.resume, state)
        if use_dist:
            from gaussian_splat_ipu_tpu.parallel import mesh as meshlib
            d_all = len(jax.devices())
            if state.params.num_gaussians % d_all:
                # shard_model would pad params past the optimizer rows.
                raise SystemExit(
                    "--resume --distributed needs a checkpoint whose "
                    f"gaussian count divides the {d_all}-device mesh")
            state = trainer.TrainState(
                params=meshlib.shard_model(state.params, mesh),
                opt_state=state.opt_state, step=state.step)
        log.info("resumed from %s at step %d", args.resume,
                 int(state.step))

    progs = build_programs(active_cfg())

    if args.densify:
        if use_dist:
            # The soft guard compares global demand against the summed
            # per-device budget render_sharded itself will use (ONE
            # definition: distributed.default_pair_budget); counted
            # overflow catches any single hot device.
            d_mesh = len(jax.devices())
            probe_capacity = distributed.default_pair_budget(
                cfg, d_mesh) * d_mesh
            _probe_one = jax.jit(
                lambda m, c: (lambda o: (o.num_pairs + o.overflow,
                                         o.overflow))(
                    distributed.render_sharded(m, c, cfg, mesh)))
        else:
            from gaussian_splat_ipu_tpu.render.pipeline import (
                render as _render)
            probe_capacity = cfg.pair_capacity
            _probe_one = jax.jit(
                lambda m, c: (lambda o: (o.num_pairs + o.overflow,
                                         o.overflow))(
                    _render(m, c, cfg, True)))

        def pair_probe(params):
            # Worst view governs: a guard probing only view 0 can pass
            # while other views overflow every epoch.
            demands = [_probe_one(params, c) for c in cameras]
            return (max(int(d) for d, _ in demands),
                    max(int(o) for _, o in demands))

    t0 = time.perf_counter()
    loss = None
    # View-batch drop accounting: device scalars per step are queued
    # (fetching them eagerly would sync every step) and drained into
    # host-side RUNNING sums at each log interval — overflow in ANY step
    # corrupts that step's gradients, so it must warn mid-run, not only
    # at the end (the densify path's per-event probe discipline).
    vb_drops = {"exchange_overflow": 0, "overflow": 0, "truncated": 0}
    vb_pending = []

    def drain_vb_stats(step_i, keep=0):
        """Fold queued per-step drop counters into the running sums.

        keep > 0 leaves the newest entries queued (their steps may still
        be in flight; int() on them would stall the dispatch pipeline —
        entries older than the pipeline depth are already complete and
        cost nothing to read)."""
        if len(vb_pending) <= keep:
            return
        since = {k: 0 for k in vb_drops}
        while len(vb_pending) > keep:
            s = vb_pending.pop(0)
            for k in since:
                since[k] += int(s[k])
        for k, v in since.items():
            vb_drops[k] += v
        if any(since.values()):
            log.warning(
                "view-batch drops by step %d: %s since last check "
                "(run totals %s) — dropped pairs corrupt gradients; "
                "raise --pair-capacity / exchange capacity",
                step_i, since, vb_drops)

    i = 0
    densify_open = True
    order_rng = np.random.default_rng(0xC0FFEE)

    def view_order():
        """Per-epoch visit order (fresh permutation under --shuffle)."""
        if args.shuffle:
            return jnp.asarray(order_rng.permutation(args.views), jnp.int32)
        return jnp.arange(args.views, dtype=jnp.int32)

    def epoch_chunks():
        """Per-epoch (order, targets) pieces for the epoch programs.

        Without --max-device-views: one piece, the device-resident
        target stack gathered by the full visit order. With it: slices
        of a host-side store, uploaded per call (the final short slice
        wraps a few duplicate views so every piece compiles once)."""
        order = np.asarray(view_order())
        n = chunk_views or args.views
        for c0 in range(0, args.views, n):
            sel = order[c0:c0 + n]
            if len(sel) < n:
                sel = np.concatenate([sel, order[:n - len(sel)]])
            sel_j = jnp.asarray(sel, jnp.int32)
            tgt = (targets_src[sel] if chunk_views
                   else targets_src[sel_j])
            yield sel_j, tgt

    step_order = list(range(args.views))

    def next_step_index(i):
        """Tail-step view index (re-shuffled at each epoch boundary)."""
        k = i % args.views
        if k == 0 and args.shuffle:
            order_rng.shuffle(step_order)
        return step_order[k]

    while i < args.steps:
        if (args.sh_step_every > 0 and active_sh < full_sh_degree
                and i // args.sh_step_every > active_sh):
            active_sh = min(full_sh_degree, i // args.sh_step_every)
            progs = build_programs(active_cfg())
            log.info("SH schedule: active degree -> %d at step %d",
                     active_sh, i)
        if args.densify:
            for sel, tgt in epoch_chunks():
                state, dstate, losses_ep = progs["epoch_densify"](
                    state, dstate, sel, tgt)
            loss = losses_ep[-1]
            i += args.views
            c = dcfg
            if (densify_open
                    and c.densify_from_step <= i <= c.densify_until_step
                    and i % c.densify_every == 0):
                state, dstate = densify_lib.densify_and_prune(state, dstate,
                                                              c)
                # Guard the pair budget: overflowed pairs drop arbitrary
                # gaussians and corrupt gradients (training diverges), so
                # stop growing before demand reaches capacity.
                demand, ovf = pair_probe(state.params)
                if int(ovf) > 0:
                    log.warning("pair overflow (%d dropped) — raise "
                                "--pair-capacity", int(ovf))
                if demand > int(0.8 * probe_capacity):
                    densify_open = False
                    log.info("pair demand %d near capacity %d: no further "
                             "densification", demand, probe_capacity)
                alive_now = int(jnp.sum(dstate.alive))
                slot_cap = state.params.num_gaussians
                if (args.auto_grow and densify_open
                        and alive_now > int(0.9 * slot_cap)):
                    if use_dist:
                        state, dstate = distributed.grow_capacity_sharded(
                            mesh, state, dstate, 2 * slot_cap)
                    else:
                        state, dstate = densify_lib.grow_capacity(
                            state, dstate, 2 * slot_cap)
                    log.info("slot buffer grown to %d (one recompile)",
                             2 * slot_cap)
                log.info("densify at step %d: %d gaussians alive "
                         "(%d pairs)", i, alive_now, demand)
            # Reset only while densification is still running (pruning must
            # be able to harvest the reset) and never near the end: the
            # model needs a few hundred steps to recover from a reset.
            if (densify_open and c.reset_opacity_every
                    and i % c.reset_opacity_every < args.views
                    and i >= c.reset_opacity_every
                    and i <= min(args.steps - 500, c.densify_until_step)):
                state = densify_lib.reset_opacity(state, dstate, c)
        elif args.view_batch > 1:
            g = (i // args.view_batch) % len(vb_groups)
            gc, gt = vb_groups[g]
            state, loss, vb_stats = progs["vb_step"](state, gc, gt)
            vb_pending.append(vb_stats)
            # Entries older than the dispatch-pipeline depth are complete:
            # reading them is free and surfaces sustained overflow NOW.
            drain_vb_stats(i, keep=4)
            i += args.view_batch
        elif "epoch_depth" in progs and args.steps - i >= args.views:
            for sel, tgt in epoch_chunks():
                state, losses_ep = progs["epoch_depth"](state, sel, tgt)
            loss = losses_ep[-1]
            i += args.views
        elif "step_depth" in progs:
            k = next_step_index(i)
            state, loss = progs["step_depth"](state, jnp.int32(k),
                                              cameras[k], targets[k])
            i += 1
        elif "epoch_aux" in progs and args.steps - i >= args.views:
            for sel, tgt in epoch_chunks():
                state, austate, losses_ep = progs["epoch_aux"](
                    state, austate, sel, tgt)
            loss = losses_ep[-1]
            i += args.views
        elif "step_aux" in progs:
            k = next_step_index(i)
            state, austate, loss = progs["step_aux"](
                state, austate, jnp.int32(k), cameras[k], targets[k])
            i += 1
        elif not use_dist and args.steps - i >= args.views:
            for sel, tgt in epoch_chunks():
                state, losses_ep = progs["epoch"](state, sel, tgt)
            loss = losses_ep[-1]
            i += args.views
        else:
            k = next_step_index(i)
            state, loss = progs["step"](state, cameras[k], targets[k])
            i += 1
        if (i // args.views) % 10 == 0 or i >= args.steps:
            log.info("step %d: loss %.5f", i, float(loss))
            drain_vb_stats(i)
    jax.block_until_ready(state.params.means)
    drain_vb_stats(i)
    if any(vb_drops.values()):
        log.warning("view-batch drop totals over the run: %s — raise "
                    "--pair-capacity / exchange capacity", vb_drops)
    dt = time.perf_counter() - t0
    log.info("trained %d steps in %.1fs (%.2f it/s incl. dispatch)",
             args.steps, dt, args.steps / dt)

    # Report PSNR against the held camera 0 target.
    pstate = austate.pose if austate is not None else None
    estate = austate.exposure if austate is not None else None
    if estate is not None:
        from gaussian_splat_ipu_tpu.train import appearance as app_lib
        dev = np.abs(np.asarray(estate.mats)
                     - np.asarray(app_lib.identity_mats(args.views)))
        log.info("exposure compensation: mean |dev| %.4g, max %.4g",
                 float(dev.mean()), float(dev.max()))
    cam0 = cameras[0]
    if pstate is not None:
        from gaussian_splat_ipu_tpu.train import pose_opt as pose_lib
        cam0 = pose_lib.apply_delta(cam0, pstate.deltas[0])
        mags = np.linalg.norm(np.asarray(pstate.deltas), axis=1)
        log.info("pose refinement: mean |delta| %.4g, max %.4g",
                 float(mags.mean()), float(mags.max()))
    final = render_jit(state.params, cam0, cfg, True)
    psnr = float(losses.psnr(final[..., :3], targets[0][..., :3]))
    log.info("PSNR vs target view 0: %.2f dB", psnr)
    eval_psnr = None
    if holdout_cams:
        vals = []
        for cam, tgt in zip(holdout_cams, holdout_targets):
            pred = render_jit(state.params, cam, cfg, True)
            vals.append(float(losses.psnr(pred[..., :3],
                                          jnp.asarray(tgt[..., :3]))))
        eval_psnr = float(np.mean(vals))
        log.info("holdout eval: %.2f dB mean PSNR over %d unseen views",
                 eval_psnr, len(vals))
    if args.densify:
        log.info("final gaussian count: %d (capacity %d)",
                 int(jnp.sum(dstate.alive)), state.params.num_gaussians)

    def host_tree(tree):
        """Materialise a (possibly multi-process-sharded) pytree on every
        host. process_allgather is a collective: ALL processes call it,
        only the primary writes files. Fully-addressable leaves (the
        optimizer's 0-d step counts etc. — identical on every process by
        SPMD construction) are taken as-is: process_allgather would
        expand_dims+concat them to shape (nproc, ...)."""
        if not multiproc:
            return tree
        from jax.experimental import multihost_utils

        def gather(x):
            if not isinstance(x, jax.Array) or x.is_fully_addressable:
                return np.asarray(x)
            return multihost_utils.process_allgather(x, tiled=True)

        return jax.tree.map(gather, tree)

    if args.checkpoint:
        state_h = trainer.TrainState(params=host_tree(state.params),
                                     opt_state=host_tree(state.opt_state),
                                     step=state.step)
        if args.densify:
            payload = (state_h, host_tree(dstate))
        elif austate is not None:
            payload = (state_h, austate)
        else:
            payload = state_h
        if multihost.is_primary():
            checkpoint.save_checkpoint(args.checkpoint, payload)
            log.info("checkpoint -> %s", args.checkpoint)
    if args.export_ply:
        params = state.params
        if multiproc and use_dist and not args.densify:
            # Config-5 scale: no host ever gathers the full model — each
            # process pwrites its row slice into one shared PLY.
            multihost.export_ply_sharded(args.export_ply, params)
            if multihost.is_primary():
                log.info("scene -> %s (sharded write)", args.export_ply)
        else:
            if use_dist:
                # Gather BEFORE compact: compact's output shape is
                # data-dependent (host-side op, not SPMD-able).
                params = host_tree(params)
                params = GaussianModel(*[jnp.asarray(np.asarray(x)) for x
                                         in jax.tree_util.tree_leaves(
                                             params)])
            if args.densify:
                params = densify_lib.compact(params, dstate)
            if multihost.is_primary():
                checkpoint.export_ply(args.export_ply, params)
                log.info("scene -> %s", args.export_ply)
    if args.export_splat:
        from gaussian_splat_ipu_tpu.io import splat as splat_io
        params = host_tree(state.params)
        params = GaussianModel(*[jnp.asarray(np.asarray(x)) for x in
                                 jax.tree_util.tree_leaves(params)])
        if args.densify:
            params = densify_lib.compact(params, dstate)
        if multihost.is_primary():
            splat_io.write_splat(args.export_splat, params)
            log.info("scene -> %s (.splat)", args.export_splat)
    tail = f" eval_psnr={eval_psnr:.2f}" if eval_psnr is not None else ""
    print(f"final_loss={float(loss):.6f} psnr={psnr:.2f}{tail}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
