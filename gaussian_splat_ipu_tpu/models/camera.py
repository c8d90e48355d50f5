"""Camera state passed to the renderer each frame.

The reference streams three small tensors to the device per frame — the
model-view matrix, the projection matrix and (fov, scale) focal params
(src/splat/ipu_rasteriser.cpp:86-110, 265-278) — then Copy-broadcasts them to
all 1440 tiles. Here a Camera is a tiny pytree of (4,4) matrices; under
jit it is replicated across the mesh by a NamedSharding with no explicit
broadcast program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_splat_ipu_tpu.ops import transforms


@jax.tree_util.register_pytree_node_class
class Camera:
    """View + projection for one frame. A pytree; static shape."""

    def __init__(self, view: jnp.ndarray, proj: jnp.ndarray,
                 env_rot: jnp.ndarray | None = None):
        self.view = view
        self.proj = proj
        # Environment rotation (x, y) radians: rotates the directional
        # appearance field (SH view directions) — the splat-native
        # analogue of the reference's env-light rotation, which its UI
        # forwards to the env shader (InterfaceServer.hpp:24-43
        # env_rotation packets). Zero = unrotated.
        self.env_rot = (jnp.zeros((2,), jnp.float32)
                        if env_rot is None
                        else jnp.asarray(env_rot, jnp.float32))

    def tree_flatten(self):
        return ((self.view, self.proj, self.env_rot), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        # Bypass __init__: the pytree contract requires unflatten to
        # accept ARBITRARY leaf stand-ins (tracers, ShapeDtypeStructs,
        # jax-internal ArgInfo during jit(...).lower(...)); __init__'s
        # jnp.asarray coercion would choke on them.
        obj = object.__new__(cls)
        obj.view, obj.proj, obj.env_rot = children
        return obj

    # ---------------------------------------------------------------------
    @property
    def view_proj(self) -> jnp.ndarray:
        return jnp.dot(self.proj, self.view,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)

    def focals(self, width: int, height: int):
        """Pixel focal lengths and fov tangents, derived from proj.

        proj[0,0] = 2*near/(r-l) scales NDC; pixel focal = proj[0,0]*W/2.
        tan(half fov) = 1/proj[0,0] (symmetric frustum).
        """
        fx = self.proj[0, 0] * (width * 0.5)
        fy = self.proj[1, 1] * (height * 0.5)
        tan_fovx = 1.0 / self.proj[0, 0]
        tan_fovy = 1.0 / self.proj[1, 1]
        return fx, fy, tan_fovx, tan_fovy

    @property
    def cam_origin(self) -> jnp.ndarray:
        """Camera position in world space (for SH view directions)."""
        r = self.view[:3, :3]
        t = self.view[:3, 3]
        return -jnp.dot(r.T, t, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)

    # -- constructors -------------------------------------------------------
    @classmethod
    def look_at(cls, eye, center, up, fov_y_radians: float, aspect: float,
                near: float = 0.01, far: float = 1000.0) -> "Camera":
        """Free camera: look-at view + symmetric perspective frustum."""
        view = transforms.look_at(jnp.asarray(eye, jnp.float32),
                                  jnp.asarray(center, jnp.float32),
                                  jnp.asarray(up, jnp.float32))
        proj = transforms.perspective(fov_y_radians, aspect, near, far)
        return cls(view, proj.astype(jnp.float32))

    @classmethod
    def from_intrinsics(cls, fx, fy, cx, cy, width: int, height: int,
                        w2c, near: float = 0.01,
                        far: float = 1000.0) -> "Camera":
        """Pinhole camera from OpenCV/COLMAP-convention intrinsics.

        fx/fy/cx/cy are in pixels with (0, 0) the top-left corner and v
        increasing DOWNWARD; `w2c` is the (4, 4) world->camera transform
        in the OpenCV axes convention (camera looks down +z, y down).
        The renderer's camera looks down -z with no viewport flip
        (clip_to_screen, ops/transforms.py), so the view flips z only and
        the projection carries the principal-point offsets:

            u = fx*X/Z + cx,  v = fy*Y/Z + cy

        lands at rendered pixel (u, v) with row 0 the image's top row —
        i.e. rendered arrays compare directly against images loaded
        top-row-first (the universal image-file order).
        """
        w2c = jnp.asarray(w2c, jnp.float32)
        view = w2c * jnp.array([[1.0], [1.0], [-1.0], [1.0]], jnp.float32)
        w, h = float(width), float(height)
        proj = jnp.array([
            [2.0 * fx / w, 0.0, 1.0 - 2.0 * cx / w, 0.0],
            [0.0, 2.0 * fy / h, 1.0 - 2.0 * cy / h, 0.0],
            [0.0, 0.0, -(far + near) / (far - near),
             -2.0 * far * near / (far - near)],
            [0.0, 0.0, -1.0, 0.0],
        ], jnp.float32)
        return cls(view, proj)

    @classmethod
    def orbit(cls, bb_min, bb_max, fov_radians: float, aspect: float,
              rot_x_deg=0.0, rot_y_deg=0.0, translation=(0.0, 0.0, 0.0),
              up=(0.0, 1.0, 1.0), env_rot=None) -> "Camera":
        """Orbit camera around a scene bounding box.

        Parity with the reference interactive loop's view synthesis
        (src/main/splat.cpp:186-195, 312-314): lookAtBoundingBox then
        rotate about x and y, then translate.
        """
        # jnp.radians keeps this traceable: the render loop jits frame
        # synthesis with the orbit angles as traced scalars, so per-frame
        # camera math runs on-device instead of as eager host dispatches.
        view = transforms.look_at_bounding_box(bb_min, bb_max, up)
        hp = jax.lax.Precision.HIGHEST
        view = jnp.dot(view, transforms.rotate_x(jnp.radians(rot_x_deg)),
                       precision=hp)
        view = jnp.dot(view, transforms.rotate_y(jnp.radians(rot_y_deg)),
                       precision=hp)
        view = jnp.dot(view, transforms.translate(translation), precision=hp)
        # Project the world bb into eye space for frustum fitting, as the
        # reference does (src/main/splat.cpp:188-195).
        base = transforms.look_at_bounding_box(bb_min, bb_max, up)
        corners = jnp.stack([jnp.asarray(bb_min, jnp.float32),
                             jnp.asarray(bb_max, jnp.float32)])
        eye = transforms.transform_points(base, corners)[:, :3]
        proj = transforms.fit_frustum_to_bounding_box(eye[0], eye[1],
                                                      fov_radians, aspect)
        return cls(view.astype(jnp.float32), proj.astype(jnp.float32),
                   env_rot)
