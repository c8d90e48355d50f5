"""Gaussian covariance math: 3D covariance, EWA 2D projection, conics.

Rebuild of the reference Gaussian math
(include/splat/ipu_geometry.hpp:232-384). Everything is written as
vectorized component expressions over (N,) arrays — pure element-wise
work, no (N,3,3) batched small matmuls — and stays strictly in float32 (the
reference's float-only discipline, include/math/README.md:1-9).

Note on fidelity: the reference's ComputeCov2D (ipu_geometry.hpp:333-383)
deviates from the standard 3DGS EWA formulation by building the Jacobian
around proj*view instead of the view matrix. We implement the standard,
correct EWA splatting (Zwicker et al. / Kerbl et al.): the reference's
clamping (1.3*tan_fov), low-pass (+0.3 on the diagonal), 3-sigma radius and
conic formulas are preserved exactly.
"""

from __future__ import annotations

import jax.numpy as jnp

from gaussian_splat_ipu_tpu.ops.transforms import quat_to_rotmat


def covariance_3d(log_scales: jnp.ndarray, quats: jnp.ndarray):
    """(N,3) log-scales + (N,4) quats -> 3D covariance upper triangle.

    Returns six (N,) arrays (xx, xy, xz, yy, yz, zz) of Sigma = R S S^T R^T.
    Parity with ComputeCov3D (ipu_geometry.hpp:315-323): scales are stored in
    log space and exponentiated here.
    """
    s = jnp.exp(log_scales.astype(jnp.float32))
    r = quat_to_rotmat(quats.astype(jnp.float32))  # (N, 3, 3)
    # M = R * diag(s); Sigma = M M^T. Component-wise, element-wise ops.
    m = r * s[..., None, :]
    xx = jnp.sum(m[..., 0, :] * m[..., 0, :], -1)
    xy = jnp.sum(m[..., 0, :] * m[..., 1, :], -1)
    xz = jnp.sum(m[..., 0, :] * m[..., 2, :], -1)
    yy = jnp.sum(m[..., 1, :] * m[..., 1, :], -1)
    yz = jnp.sum(m[..., 1, :] * m[..., 2, :], -1)
    zz = jnp.sum(m[..., 2, :] * m[..., 2, :], -1)
    return xx, xy, xz, yy, yz, zz


def ewa_project(t_view: jnp.ndarray, cov3d, view: jnp.ndarray,
                focal_x, focal_y, tan_fovx, tan_fovy,
                lowpass: float = 0.3):
    """EWA projection of 3D covariances to 2D screen-space covariances.

    Args:
      t_view: (N, 3) gaussian centres in view space (camera looks down -z).
      cov3d: tuple of six (N,) upper-triangle components from covariance_3d.
      view: (4, 4) view matrix (only its rotation part is used).
      focal_x/focal_y: focal lengths in pixels.
      tan_fovx/tan_fovy: tangents of the half field of view.
      lowpass: added to the output diagonal so every gaussian is >= ~1px
        (reference ipu_geometry.hpp:377-378).

    Returns (a, b, c): the three (N,) components of the symmetric 2x2
    screen-space covariance [[a, b], [b, c]].
    """
    xx, xy, xz, yy, yz, zz = cov3d
    tx, ty, tz = t_view[..., 0], t_view[..., 1], t_view[..., 2]

    # Clamp the lateral extent to 1.3x the frustum like the reference
    # (ipu_geometry.hpp:338-343) to bound the Jacobian near the edges.
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    txtz = tx / tz
    tytz = ty / tz
    tx = jnp.clip(txtz, -limx, limx) * tz
    ty = jnp.clip(tytz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    # Perspective Jacobian J (2x3):
    #   [ fx/tz   0      -fx*tx/tz^2 ]
    #   [ 0       fy/tz  -fy*ty/tz^2 ]
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2

    # W = rotation part of the view matrix (rows).
    w = view[:3, :3]
    # U = J @ W: (N, 2, 3), expanded component-wise.
    u00 = j00 * w[0, 0] + j02 * w[2, 0]
    u01 = j00 * w[0, 1] + j02 * w[2, 1]
    u02 = j00 * w[0, 2] + j02 * w[2, 2]
    u10 = j11 * w[1, 0] + j12 * w[2, 0]
    u11 = j11 * w[1, 1] + j12 * w[2, 1]
    u12 = j11 * w[1, 2] + j12 * w[2, 2]

    # cov2d = U Sigma U^T, Sigma symmetric with the six given components.
    # First V = U Sigma (2x3):
    v00 = u00 * xx + u01 * xy + u02 * xz
    v01 = u00 * xy + u01 * yy + u02 * yz
    v02 = u00 * xz + u01 * yz + u02 * zz
    v10 = u10 * xx + u11 * xy + u12 * xz
    v11 = u10 * xy + u11 * yy + u12 * yz
    v12 = u10 * xz + u11 * yz + u12 * zz

    a0 = v00 * u00 + v01 * u01 + v02 * u02
    b = v00 * u10 + v01 * u11 + v02 * u12
    c0 = v10 * u10 + v11 * u11 + v12 * u12
    return a0 + lowpass, b, c0 + lowpass


def aa_opacity_compensation(a, b, c, lowpass: float):
    """Mip-splatting style antialiasing factor in (0, 1].

    The +lowpass dilation (above) keeps every splat >= ~1px but ADDS
    energy to sub-pixel splats (their peak alpha stays while their area
    grows). Scaling opacity by sqrt(det(cov) / det(cov + lowpass)) —
    computed here from the POST-dilation (a, b, c) — conserves each
    splat's total energy, so far-away/shrunken gaussians fade instead of
    shimmering (Yu et al., "Mip-Splatting", CVPR 2024; gsplat's
    antialiased mode). Differentiable; ~1 for splats much bigger than a
    pixel."""
    det_after = a * c - b * b
    det_before = (a - lowpass) * (c - lowpass) - b * b
    ratio = jnp.maximum(det_before, 0.0) / jnp.maximum(det_after, 1e-12)
    return jnp.sqrt(jnp.clip(ratio, 0.0, 1.0))


def conic(a, b, c, eps: float = 1e-12):
    """Invert 2x2 covariances -> conic coefficients (A, B, C) and validity.

    Parity with Gaussian2D::ComputeConicOpacity (ipu_geometry.hpp:278-286):
    a degenerate covariance yields valid=False (the reference returns a zero
    conic+opacity which the blender then skips, codelets.cpp:389-391).
    """
    det = a * c - b * b
    valid = det > eps
    det_inv = jnp.where(valid, 1.0 / jnp.where(valid, det, 1.0), 0.0)
    return c * det_inv, -b * det_inv, a * det_inv, valid


def eigenvalues_2d(a, b, c, floor: float = 0.1):
    """Eigenvalues of the 2x2 covariance [[a,b],[b,c]].

    Parity with Gaussian2D::ComputeEigenvalues (ipu_geometry.hpp:247-261)
    including its 0.1 discriminant floor.
    """
    det = a * c - b * b
    mid = 0.5 * (a + c)
    disc = jnp.sqrt(jnp.maximum(floor, mid * mid - det))
    return mid + disc, mid - disc


def splat_radius(a, b, c):
    """3-sigma pixel radius of a splat, ceil'd.

    Parity with Gaussian2D::GetBoundingBox (ipu_geometry.hpp:263-276):
    radius = ceil(3 * sqrt(max eigenvalue)).
    """
    l1, _ = eigenvalues_2d(a, b, c)
    return jnp.ceil(3.0 * jnp.sqrt(jnp.maximum(l1, 0.0)))


def splat_extent(a, c, opacity=None, alpha_min: float = 1.0 / 255.0,
                 max_sigma: float = 3.0):
    """Exact per-axis half-extents (rx, ry) of the splat's footprint,
    ceil'd.

    The axis-aligned bounding box of {d : d^T Sigma^-1 d <= q} has half
    extents exactly sqrt(q*Sigma_xx), sqrt(q*Sigma_yy) — strictly tighter
    than the circumscribed sqrt(q*lambda_max) square (reference
    GetBoundingBox) for anisotropic splats: fewer (gaussian, tile) pairs
    enumerated for identical coverage, which scales the whole binning +
    rasterize pipeline down proportionally.

    With `opacity`, q is ALPHA-AWARE: every compositing path skips pixels
    with alpha = opacity*exp(-q/2) < alpha_min, so the footprint only
    needs q = 2*ln(opacity/alpha_min) — beyond it the pixel is skipped
    anyway. Dim splats get much smaller boxes (free pair reduction, the
    image is bitwise unchanged); `max_sigma > 0` caps q at max_sigma^2
    (the classic 3-sigma bound), while max_sigma=0 leaves it uncapped,
    making the tiled pipeline pixel-exact vs the dense oracle even for
    near-opaque splats (whose alpha_min radius is ~3.33 sigma).
    """
    if opacity is None:
        q = max_sigma * max_sigma
    else:
        q = 2.0 * jnp.log(jnp.maximum(opacity, 1e-12) / alpha_min)
        if max_sigma > 0.0:
            q = jnp.minimum(q, max_sigma * max_sigma)
        q = jnp.maximum(q, 0.0)
    rx = jnp.ceil(jnp.sqrt(q * jnp.maximum(a, 0.0)))
    ry = jnp.ceil(jnp.sqrt(q * jnp.maximum(c, 0.0)))
    return rx, ry
