"""Camera and point transforms (pure JAX, f32).

Covers the reference's camera stack: lookAtBoundingBox
(src/splat/camera.cpp:10-15), fitFrustumToBoundingBox
(src/splat/geometry.cpp:9-24), Viewport (include/splat/viewport.hpp:21-35),
and the AMP 4x4 point transform (codelets/splat/codelets.cpp:741-871) which
here collapses to a single batched matmul.

Conventions (OpenGL style, matching the reference):
  * world -> view via a right-handed lookAt; the camera looks down -z.
  * view -> clip via glm::frustum-equivalent perspective matrix.
  * clip -> screen: (x/w * 0.5 + 0.5) * width  (no y flip;
    viewport.hpp:21-35).
Matrices act on column vectors: p' = M @ p.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def look_at(eye, center, up) -> jnp.ndarray:
    """Right-handed lookAt view matrix (glm::lookAt semantics)."""
    eye = jnp.asarray(eye, jnp.float32)
    center = jnp.asarray(center, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    f = center - eye
    f = f / jnp.linalg.norm(f)
    s = jnp.cross(f, up)
    s = s / jnp.linalg.norm(s)
    u = jnp.cross(s, f)
    m = jnp.stack([
        jnp.concatenate([s, jnp.array([-jnp.sum(s * eye)])]),
        jnp.concatenate([u, jnp.array([-jnp.sum(u * eye)])]),
        jnp.concatenate([-f, jnp.array([jnp.sum(f * eye)])]),
        jnp.array([0.0, 0.0, 0.0, 1.0]),
    ])
    return m.astype(jnp.float32)


def look_at_bounding_box(bb_min, bb_max, up=(0.0, 1.0, 1.0),
                         scale: float = 1.0) -> jnp.ndarray:
    """Camera `scale` bounding-radii down +z looking at the box centroid.

    Parity with reference lookAtBoundingBox (src/splat/camera.cpp:10-15).
    """
    bb_min = jnp.asarray(bb_min, jnp.float32)
    bb_max = jnp.asarray(bb_max, jnp.float32)
    center = (bb_min + bb_max) * 0.5
    radius = jnp.linalg.norm(bb_max - bb_min) * 0.5
    eye = center - jnp.array([0.0, 0.0, scale * radius], jnp.float32)
    return look_at(eye, center, jnp.asarray(up, jnp.float32))


def frustum(left, right, bottom, top, near, far) -> jnp.ndarray:
    """glm::frustum-equivalent OpenGL perspective projection matrix."""
    l, r, b, t, n, f = (jnp.float32(v) for v in (left, right, bottom, top,
                                                 near, far))
    return jnp.array([
        [2 * n / (r - l), 0.0, (r + l) / (r - l), 0.0],
        [0.0, 2 * n / (t - b), (t + b) / (t - b), 0.0],
        [0.0, 0.0, -(f + n) / (f - n), -2 * f * n / (f - n)],
        [0.0, 0.0, -1.0, 0.0],
    ], jnp.float32)


def fit_frustum_to_bounding_box(bb_min, bb_max, fov_radians: float,
                                aspect: float) -> jnp.ndarray:
    """Frustum fitted to a camera-space bounding box.

    Parity with reference fitFrustumToBoundingBox
    (src/splat/geometry.cpp:9-24): near = radius/tan(fov),
    far = near + 20*radius, half extents = radius*(aspect, 1).
    """
    bb_min = jnp.asarray(bb_min, jnp.float32)
    bb_max = jnp.asarray(bb_max, jnp.float32)
    radius = jnp.linalg.norm(bb_max - bb_min) * 0.5
    near = radius / jnp.tan(jnp.float32(fov_radians))
    far = near + 20.0 * radius
    return frustum(-radius * aspect, radius * aspect, -radius, radius, near,
                   far)


def perspective(fov_y_radians, aspect, near, far) -> jnp.ndarray:
    """Symmetric perspective projection (gluPerspective semantics)."""
    t = jnp.tan(jnp.float32(fov_y_radians) * 0.5) * jnp.float32(near)
    return frustum(-t * aspect, t * aspect, -t, t, near, far)


def rotate_x(radians) -> jnp.ndarray:
    c, s = jnp.cos(jnp.float32(radians)), jnp.sin(jnp.float32(radians))
    return jnp.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                     jnp.float32)


def rotate_y(radians) -> jnp.ndarray:
    c, s = jnp.cos(jnp.float32(radians)), jnp.sin(jnp.float32(radians))
    return jnp.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                     jnp.float32)


def translate(v) -> jnp.ndarray:
    v = jnp.asarray(v, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(v)


def transform_points(matrix: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Batched 4x4 transform of (N, 3|4) points: one matmul.

    This single line supersedes the reference's hand-written AMP systolic
    assembly (codelets/splat/codelets.cpp:656-871); XLA schedules it.
    """
    points = jnp.asarray(points, jnp.float32)
    if points.shape[-1] == 3:
        points = jnp.concatenate(
            [points, jnp.ones(points.shape[:-1] + (1,), points.dtype)],
            axis=-1)
    # K=4 contraction: full-f32 precision costs nothing (memory bound) and
    # keeps screen positions exact.
    return jnp.dot(points, matrix.T, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def clip_to_screen(clip: jnp.ndarray, width, height) -> jnp.ndarray:
    """Perspective divide + viewport transform -> (N, 2) pixel coords.

    Parity with Viewport::clipSpaceToViewport (viewport.hpp:21-35): no y
    flip, viewport origin at (0, 0).
    """
    w = clip[..., 3:4]
    xy = clip[..., 0:2] * (0.5 / w) + 0.5
    return xy * jnp.array([width, height], jnp.float32)


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """(N, 4) quaternions (w, x, y, z) -> (N, 3, 3) rotation matrices.

    Normalizes first (reference ComputeCov3D normalizes via glm,
    include/splat/ipu_geometry.hpp:315-323).
    """
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], -1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], -1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], -1),
    ], -2)
