"""Projection stage: gaussian parameters -> screen-space splats.

The vectorized equivalent of the per-gaussian front half of the
reference's fused GSplat vertex (codelets/splat/codelets.cpp:437-505):
MVP transform (one matmul over all N), viewport mapping, EWA cov2D,
conic + radius, frustum cull. Runs unchanged on every path (oracle renderer,
binning pipeline, distributed shard_map) — one projection, many consumers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu.ops import covariance, sh, transforms
from gaussian_splat_ipu_tpu.utils.config import RasterConfig


class ProjectedSplats(NamedTuple):
    """Screen-space splats, all (N,) or (N, k) f32."""

    xy: jnp.ndarray        # (N, 2) pixel centre
    depth: jnp.ndarray     # (N,) view-space depth (positive in front)
    conic: jnp.ndarray     # (N, 3) inverse 2D covariance (A, B, C)
    color: jnp.ndarray     # (N, 3) RGB
    opacity: jnp.ndarray   # (N,) post-activation opacity
    radius: jnp.ndarray    # (N, 2) exact 3-sigma AABB half-extents
    #                        (rx, ry) in pixels; (0, 0) => culled


def project_gaussians(model: GaussianModel, camera: Camera,
                      cfg: RasterConfig,
                      xy_probe: jnp.ndarray | None = None
                      ) -> ProjectedSplats:
    """xy_probe: optional (N, 2) zeros added to the screen position — a
    gradient probe: d(loss)/d(xy_probe) is the per-gaussian screen-space
    positional gradient that drives densification (train/densify.py)."""
    means = model.means.astype(jnp.float32)
    n = means.shape[0]

    # World -> view and view -> clip.
    view_h = transforms.transform_points(camera.view, means)      # (N, 4)
    clip = transforms.transform_points(camera.proj, view_h)        # (N, 4)
    t_view = view_h[:, :3]
    depth = -t_view[:, 2]  # camera looks down -z; positive in front

    xy = transforms.clip_to_screen(clip, cfg.image_width, cfg.image_height)
    if xy_probe is not None:
        xy = xy + xy_probe

    fx, fy, tan_fovx, tan_fovy = camera.focals(cfg.image_width,
                                               cfg.image_height)
    cov3d = covariance.covariance_3d(model.log_scales, model.quats)
    a, b, c = covariance.ewa_project(t_view, cov3d, camera.view, fx, fy,
                                     tan_fovx, tan_fovy, cfg.lowpass)
    ca, cb, cc, conic_valid = covariance.conic(a, b, c)

    opacity = model.opacities.astype(jnp.float32)
    if cfg.sigmoid_opacity:
        opacity = jax.nn.sigmoid(opacity)
    if cfg.antialias:
        # Energy-conserving lowpass (Mip-Splatting): sub-pixel splats
        # fade with distance instead of brightening when dilated.
        opacity = opacity * covariance.aa_opacity_compensation(
            a, b, c, cfg.lowpass)
    # Alpha-aware footprint: the box only covers pixels whose alpha can
    # clear alpha_min (extents gradient-free — ceil kills the tangent, so
    # this adds no backward cost). lax.stop_gradient keeps the forward
    # graph honest about it.
    rx, ry = covariance.splat_extent(
        a, c, jax.lax.stop_gradient(opacity), cfg.alpha_min,
        cfg.extent_sigma)

    # Colour: SH evaluated along the view direction (degree 0 reduces to the
    # reference's SH_C0*f_dc+0.5, src/main/splat.cpp:136-148).
    degree = model.sh_degree
    if cfg.active_sh_degree >= 0:
        degree = min(degree, cfg.active_sh_degree)
    if degree == 0:
        color = sh.dc_to_rgb(model.sh[:, 0])
    else:
        dirs = means - camera.cam_origin[None, :]
        dirs = dirs / jnp.maximum(
            jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-8)
        # Environment rotation: spin the directional appearance field
        # (the reference rotates its env light the same two axes,
        # InterfaceServer.hpp env_rotation packets). Identity at zero.
        rot = jnp.dot(transforms.rotate_y(camera.env_rot[1])[:3, :3],
                      transforms.rotate_x(camera.env_rot[0])[:3, :3],
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        dirs = jnp.dot(dirs, rot.T, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        color = sh.eval_sh(model.sh, dirs, degree)

    # Frustum cull: in front of the near plane and on screen (with radius
    # guard band). The reference culls with clipSpace.z < 0
    # (codelets.cpp:493) — a quirk of its frustum that drops the far half of
    # the scene; we do a standard visibility test instead.
    w = clip[:, 3]
    near_ok = w > 1e-6
    on_screen = ((xy[:, 0] + rx >= 0.0)
                 & (xy[:, 0] - rx <= cfg.image_width)
                 & (xy[:, 1] + ry >= 0.0)
                 & (xy[:, 1] - ry <= cfg.image_height))
    visible = near_ok & on_screen & conic_valid & (rx > 0.0) & (
        ry > 0.0) & (opacity >= cfg.alpha_min)
    radius = jnp.where(visible[:, None],
                       jnp.stack([rx, ry], -1), 0.0)

    return ProjectedSplats(
        xy=xy,
        depth=depth,
        conic=jnp.stack([ca, cb, cc], -1),
        color=color,
        opacity=opacity,
        radius=radius,
    )
