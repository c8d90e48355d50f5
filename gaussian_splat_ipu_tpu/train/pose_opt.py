"""Joint camera-pose refinement: per-view SE(3) corrections optimised
with the scene.

Real captures carry COLMAP pose error; because this renderer's Camera is
an ordinary pytree of traced matrices (models/camera.py) the whole render
is differentiable in the view matrix for free — so pose refinement is
just six extra parameters per view, no special machinery. The reference
(a forward-only viewer, src/main/splat.cpp) has no counterpart; this is a
north-star training extension in the nerfstudio/BARF tradition.

Parameterisation: a tangent-space delta d = (w, v) in R^6 per view.
The corrected view is  view' = exp([w]x | v) @ view  — a left-multiplied
small rigid motion in CAMERA space (rotation applied about the camera
origin, then a translation), which keeps the update well-conditioned
regardless of where the world origin sits. exp is the exact SO(3)
Rodrigues map with a Taylor guard at theta -> 0; the translation column
uses the exact SE(3) V-matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu.render.pipeline import render_image
from gaussian_splat_ipu_tpu.train import losses, trainer
from gaussian_splat_ipu_tpu.utils.config import RasterConfig


def _hat(w: jnp.ndarray) -> jnp.ndarray:
    """(3,) -> 3x3 skew-symmetric [w]x."""
    zero = jnp.zeros((), w.dtype)
    return jnp.array([[zero, -w[2], w[1]],
                      [w[2], zero, -w[0]],
                      [-w[1], w[0], zero]])


def se3_exp(delta: jnp.ndarray) -> jnp.ndarray:
    """Exact SE(3) exponential of a (6,) tangent (w, v) -> (4, 4).

    Rodrigues with series fallbacks below theta^2 = 1e-8 so the map (and
    its gradient) is exact and smooth at the zero initialisation.
    """
    w, v = delta[:3], delta[3:]
    th2 = jnp.dot(w, w, precision=jax.lax.Precision.HIGHEST)
    small = th2 < 1e-8
    # Double-where: the unselected exact branch must still evaluate (and
    # differentiate) finitely at th -> 0, else its NaN poisons the
    # gradient of the whole where. Substitute a safe denominator first.
    th2s = jnp.where(small, 1.0, th2)
    th = jnp.sqrt(th2s)
    # sin(th)/th, (1-cos th)/th^2, (th - sin th)/th^3 with Taylor guards.
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / th)
    b = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / th2s)
    c = jnp.where(small, 1.0 / 6.0 - th2 / 120.0,
                  (th - jnp.sin(th)) / (th2s * th))
    k = _hat(w)
    k2 = jnp.dot(k, k, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    eye = jnp.eye(3, dtype=delta.dtype)
    r = eye + a * k + b * k2
    vmat = eye + b * k + c * k2
    out = jnp.eye(4, dtype=delta.dtype)
    out = out.at[:3, :3].set(r)
    out = out.at[:3, 3].set(jnp.dot(vmat, v,
                                    preferred_element_type=jnp.float32,
                                    precision=jax.lax.Precision.HIGHEST))
    return out


def apply_delta(camera: Camera, delta: jnp.ndarray) -> Camera:
    """Left-multiply the view by the exp of a (6,) tangent delta."""
    corr = se3_exp(delta)
    return Camera(view=jnp.dot(corr, camera.view,
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST),
                  proj=camera.proj, env_rot=camera.env_rot)


class PoseState(NamedTuple):
    deltas: jnp.ndarray          # (V, 6) f32 tangent corrections
    opt_state: optax.OptState



def make_pose_optimizer(lr: float) -> optax.GradientTransformation:
    return optax.adam(lr, b1=0.9, b2=0.999, eps=1e-15)


def init_pose_state(num_views: int, lr: float) -> PoseState:
    deltas = jnp.zeros((num_views, 6), jnp.float32)
    return PoseState(deltas=deltas,
                     opt_state=make_pose_optimizer(lr).init(deltas))


def joint_step(state: trainer.TrainState, pstate: PoseState,
               view_idx: jnp.ndarray, camera: Camera,
               target: jnp.ndarray, raster_cfg: RasterConfig,
               train_cfg: trainer.TrainConfig, pose_lr: float,
               use_pallas: bool = True,
               ) -> Tuple[trainer.TrainState, PoseState, jnp.ndarray]:
    """One step optimising scene params AND this view's pose delta.

    Jit with static (5, 6, 7, 8). `view_idx` selects the delta row, so a
    single compiled program serves every view (and rides inside the epoch
    scan in app/train.py).
    """
    tx = trainer.make_optimizer(train_cfg)
    ptx = make_pose_optimizer(pose_lr)

    def loss_fn(params, deltas):
        cam = apply_delta(camera, deltas[view_idx])
        image = render_image(params, cam, raster_cfg, use_pallas)
        return losses.render_loss(image, target, train_cfg.ssim_weight)

    loss, (gp, gd) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        state.params, pstate.deltas)
    params, opt_state = trainer.apply_param_updates(tx, state.params, gp,
                                                    state.opt_state)
    dupd, popt = ptx.update(gd, pstate.opt_state, pstate.deltas)
    deltas = optax.apply_updates(pstate.deltas, dupd)
    return (trainer.TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1),
            PoseState(deltas=deltas, opt_state=popt), loss)


def corrected_cameras(cameras, deltas: jnp.ndarray):
    """Apply learned deltas to a list of Cameras (for eval/export)."""
    return [apply_delta(cam, deltas[i]) for i, cam in enumerate(cameras)]
