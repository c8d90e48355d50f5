"""Per-view appearance (exposure) compensation, optimised with the scene.

Real captures carry per-shot exposure / white-balance drift (phone
auto-exposure, varying daylight). Without compensation the scene model
absorbs the average exposure and every view fights the others; the
standard fix (Mip-NeRF 360, many 3DGS trainers) is a tiny per-view
affine colour transform applied to the RENDERED image before the loss:

    rgb' = M @ rgb + b        M: (3, 3) init I,  b: (3,) init 0

The transform lives on the loss side only — exports/eval render the raw
scene — so it soaks up per-view nuisance without leaking into geometry.
No reference counterpart (forward-only viewer); north-star training
extension alongside train/pose_opt.py.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.render.pipeline import render_image
from gaussian_splat_ipu_tpu.train import losses, trainer
from gaussian_splat_ipu_tpu.utils.config import RasterConfig


class ExposureState(NamedTuple):
    mats: jnp.ndarray            # (V, 3, 4) [M | b] per view
    opt_state: optax.OptState


def identity_mats(num_views: int) -> jnp.ndarray:
    eye = jnp.concatenate([jnp.eye(3, dtype=jnp.float32),
                           jnp.zeros((3, 1), jnp.float32)], axis=1)
    return jnp.tile(eye[None], (num_views, 1, 1))


def make_exposure_optimizer(lr: float) -> optax.GradientTransformation:
    return optax.adam(lr, b1=0.9, b2=0.999, eps=1e-15)


def init_exposure_state(num_views: int, lr: float) -> ExposureState:
    mats = identity_mats(num_views)
    return ExposureState(mats=mats,
                         opt_state=make_exposure_optimizer(lr).init(mats))


def apply_exposure(image: jnp.ndarray, mat: jnp.ndarray) -> jnp.ndarray:
    """Affine colour map on the RGB channels of an (H, W, C>=3) image.

    One (HW, 3) x (3, 3) matmul + bias, negligible next to the render.
    Extra channels (alpha) pass through untouched.
    """
    rgb = image[..., :3]
    out = jnp.einsum("ij,hwj->hwi", mat[:, :3], rgb,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST) + mat[:, 3]
    if image.shape[-1] > 3:
        out = jnp.concatenate([out, image[..., 3:]], axis=-1)
    return out


def joint_step(state: trainer.TrainState, estate: ExposureState,
               view_idx: jnp.ndarray, camera: Camera,
               target: jnp.ndarray, raster_cfg: RasterConfig,
               train_cfg: trainer.TrainConfig, exposure_lr: float,
               use_pallas: bool = True,
               ) -> Tuple[trainer.TrainState, ExposureState, jnp.ndarray]:
    """One step optimising scene params AND this view's exposure affine.

    Jit with static (5, 6, 7, 8); `view_idx` selects the affine row so a
    single program serves every view (rides the epoch scan in
    app/train.py, same shape as pose_opt.joint_step).
    """
    tx = trainer.make_optimizer(train_cfg)
    etx = make_exposure_optimizer(exposure_lr)

    def loss_fn(params, mats):
        image = render_image(params, camera, raster_cfg, use_pallas)
        image = apply_exposure(image, mats[view_idx])
        return losses.render_loss(image, target, train_cfg.ssim_weight)

    loss, (gp, gm) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        state.params, estate.mats)
    params, opt_state = trainer.apply_param_updates(tx, state.params, gp,
                                                    state.opt_state)
    mupd, eopt = etx.update(gm, estate.opt_state, estate.mats)
    mats = optax.apply_updates(estate.mats, mupd)
    return (trainer.TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1),
            ExposureState(mats=mats, opt_state=eopt), loss)
