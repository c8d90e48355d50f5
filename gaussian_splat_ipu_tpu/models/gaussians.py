"""Gaussian scene model: the trainable parameter pytree.

Rebuild of the reference Gaussian3D record
(include/splat/ipu_geometry.hpp:305-323): where the reference packs each
gaussian into a 64-float byte-strided record pinned in tile SRAM
(src/splat/ipu_rasteriser.cpp:49-83), we keep a structure-of-arrays pytree —
the layout XLA's vectorised code wants — sharded over devices with
jax.sharding when the scene exceeds one device.

Parameters follow standard 3DGS conventions:
  means       (N, 3) world-space centres
  log_scales  (N, 3) log of per-axis scale (exp'd in covariance_3d)
  quats       (N, 4) rotations (w, x, y, z)
  opacities   (N,)   raw opacity; sigmoid applied at render time when
                     RasterConfig.sigmoid_opacity (the reference feeds the
                     PLY logit straight through, src/main/splat.cpp:149)
  sh          (N, K, 3) SH coefficients, K=(degree+1)^2; sh[:, 0] is f_dc.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
class GaussianModel:
    """Structure-of-arrays gaussian scene parameters (a JAX pytree)."""

    def __init__(self, means, log_scales, quats, opacities, sh):
        self.means = means
        self.log_scales = log_scales
        self.quats = quats
        self.opacities = opacities
        self.sh = sh

    # -- pytree protocol --------------------------------------------------
    def tree_flatten(self):
        return ((self.means, self.log_scales, self.quats, self.opacities,
                 self.sh), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # ----------------------------------------------------------------------
    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(np.sqrt(self.sh.shape[1])) - 1

    def astype(self, dtype) -> "GaussianModel":
        return jax.tree.map(lambda x: x.astype(dtype), self)

    def pad_to(self, n: int) -> "GaussianModel":
        """Zero-pad to n gaussians (padding has opacity -inf -> invisible)."""
        cur = self.num_gaussians
        if cur == n:
            return self
        assert n > cur, (n, cur)
        pad = n - cur

        def _pad(x, fill=0.0):
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths, constant_values=fill)

        return GaussianModel(
            means=_pad(self.means),
            log_scales=_pad(self.log_scales, -30.0),
            quats=jnp.concatenate(
                [self.quats,
                 jnp.tile(jnp.array([[1., 0., 0., 0.]], self.quats.dtype),
                          (pad, 1))]),
            opacities=_pad(self.opacities, -30.0),
            sh=_pad(self.sh),
        )

    def with_sh_degree(self, degree: int) -> "GaussianModel":
        """Resize the SH axis to (degree+1)^2 bands. New bands start at
        zero (the 3DGS f_rest init); extra bands are truncated."""
        k = (degree + 1) ** 2
        cur = self.sh.shape[1]
        if k == cur:
            return self
        if k < cur:
            sh = self.sh[:, :k]
        else:
            sh = jnp.pad(self.sh, ((0, 0), (0, k - cur), (0, 0)))
        return GaussianModel(self.means, self.log_scales, self.quats,
                             self.opacities, sh)

    @classmethod
    def create(cls, means, log_scales, quats, opacities, f_dc,
               f_rest: Optional[np.ndarray] = None,
               sh_degree: int = 0) -> "GaussianModel":
        """Assemble from raw arrays (e.g. parsed PLY fields).

        f_dc: (N, 3); f_rest: (N, K-1, 3) higher-order coefficients or None.
        """
        n = means.shape[0]
        k = (sh_degree + 1) ** 2
        sh = np.zeros((n, k, 3), np.float32)
        sh[:, 0] = f_dc
        if f_rest is not None and k > 1:
            sh[:, 1:] = f_rest[:, :k - 1]
        return cls(
            means=jnp.asarray(means, jnp.float32),
            log_scales=jnp.asarray(log_scales, jnp.float32),
            quats=jnp.asarray(quats, jnp.float32),
            opacities=jnp.asarray(opacities, jnp.float32),
            sh=jnp.asarray(sh, jnp.float32),
        )

    @classmethod
    def from_points(cls, xyz: np.ndarray, rgb: np.ndarray,
                    sh_degree: int = 0, opacity: float = 0.1,
                    knn: int = 3) -> "GaussianModel":
        """Standard 3DGS initialisation from an SfM point cloud
        (COLMAP points3D): one isotropic gaussian per point, scale set to
        the mean distance of the `knn` nearest neighbours (clamped away
        from zero), colour as the SH dc band, opacity at a uniform
        post-sigmoid `opacity`.

        The knn is exact and matmul-shaped: squared distances expand to
        |a|^2 + |b|^2 - 2 a.b, so the dominant cost is one (N, 3) x (3, N)
        matmul evaluated in row chunks (O(N^2) flops, O(N*chunk) memory) —
        the plain-JAX replacement for the CUDA simple-knn used by
        mainstream 3DGS trainers.
        """
        from gaussian_splat_ipu_tpu.ops.sh import SH_C0

        xyz = np.asarray(xyz, np.float32)
        rgb = np.asarray(rgb, np.float32)
        n = xyz.shape[0]
        if n == 0:
            raise ValueError("from_points: empty point cloud")
        dist = mean_knn_distance(jnp.asarray(xyz), k=knn)
        dist = jnp.maximum(dist, 1e-7)
        k = (sh_degree + 1) ** 2
        sh = np.zeros((n, k, 3), np.float32)
        sh[:, 0] = (rgb - 0.5) / SH_C0     # invert colour_from_dc
        p = float(np.clip(opacity, 1e-4, 1.0 - 1e-4))
        return cls(
            means=jnp.asarray(xyz),
            log_scales=jnp.tile(jnp.log(dist)[:, None], (1, 3)),
            quats=jnp.tile(jnp.array([[1., 0., 0., 0.]], jnp.float32),
                           (n, 1)),
            opacities=jnp.full((n,), np.log(p / (1.0 - p)), jnp.float32),
            sh=jnp.asarray(sh),
        )

    @classmethod
    def random(cls, key, n: int, sh_degree: int = 0,
               extent: float = 1.0) -> "GaussianModel":
        """Random synthetic scene (benchmarks / tests)."""
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        kk = (sh_degree + 1) ** 2
        return cls(
            means=jax.random.uniform(k1, (n, 3), jnp.float32, -extent,
                                     extent),
            log_scales=jax.random.uniform(k2, (n, 3), jnp.float32, -5.5,
                                          -3.5) + jnp.log(extent),
            quats=jax.random.normal(k3, (n, 4), jnp.float32),
            opacities=jax.random.uniform(k4, (n,), jnp.float32, -2.0, 4.0),
            sh=jax.random.uniform(k5, (n, kk, 3), jnp.float32, -1.0, 1.0),
        )

    @classmethod
    def clustered(cls, key, n: int, n_clusters: int = 64,
                  sh_degree: int = 0,
                  extent: float = 1.0) -> "GaussianModel":
        """Clustered synthetic scene (VERDICT r4 #6): Gaussian-mixture
        positions with per-cluster spread, log-normal scales, and a wide
        opacity range. Uniform random scenes have near-uniform tile
        occupancy and no occlusion coherence, which understates per-tile
        early-exit benefit and sort-segment skew; this stands in for the
        stripped real captures (reference data/point_cloud_12.ply) in
        benchmarks."""
        k1, k2, k3, k4, k5, k6, k7 = jax.random.split(key, 7)
        kk = (sh_degree + 1) ** 2
        centers = jax.random.uniform(k1, (n_clusters, 3), jnp.float32,
                                     -0.8 * extent, 0.8 * extent)
        csig = jnp.exp(jax.random.uniform(
            k2, (n_clusters,), jnp.float32,
            float(jnp.log(0.02 * extent)), float(jnp.log(0.3 * extent))))
        assign = jax.random.randint(k3, (n,), 0, n_clusters)
        means = centers[assign] + (
            jax.random.normal(k4, (n, 3), jnp.float32)
            * csig[assign][:, None])
        return cls(
            means=means,
            # log-normal scale spread around the .random() band centre
            log_scales=(jax.random.normal(k5, (n, 3), jnp.float32) * 0.6
                        - 4.5 + jnp.log(extent)),
            quats=jax.random.normal(k6, (n, 4), jnp.float32),
            opacities=jax.random.uniform(k7, (n,), jnp.float32, -4.0,
                                         6.0),
            sh=jax.random.uniform(k1, (n, kk, 3), jnp.float32, -1.0,
                                  1.0),
        )


def mean_knn_distance(xyz: jnp.ndarray, k: int = 3,
                      chunk: int = 1024) -> jnp.ndarray:
    """Mean distance to the k nearest neighbours of every point, (N,) f32.

    Exact, chunked, matmul-dominated: for each row chunk the (chunk, N)
    squared-distance matrix is |a|^2 + |b|^2 - 2 a.b (one matmul), and
    top-(k+1) smallest selects self + k neighbours. The matmul runs at full
    f32 precision: |a|^2 + |b|^2 - 2 a.b cancels, and TF32 inputs (about
    three decimal digits) would corrupt the small distances that set the
    initial scales.
    """
    n = xyz.shape[0]
    if n == 1:
        return jnp.zeros((1,), jnp.float32)  # no neighbours to measure
    k_eff = min(k, max(n - 1, 1))
    pad = (-n) % chunk
    xp = jnp.pad(xyz, ((0, pad), (0, 0)))
    sq = jnp.sum(xp * xp, axis=-1)                       # (Np,)
    rows = xp.reshape(-1, chunk, 3)
    row_sq = sq.reshape(-1, chunk)

    def one_chunk(args):
        r, rsq = args
        d2 = (rsq[:, None] + sq[None, :]
              - 2.0 * jnp.dot(r, xp.T, preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST))
        # top_k of negated distances = k+1 smallest (self included at ~0);
        # padded points sit at the origin pad-block — mask them out.
        if pad:
            d2 = d2.at[:, n:].set(jnp.inf)
        neg, _ = jax.lax.top_k(-d2, k_eff + 1)
        d2k = jnp.maximum(-neg[:, 1:], 0.0)              # drop self
        return jnp.mean(jnp.sqrt(d2k), axis=-1)

    out = jax.lax.map(one_chunk, (rows, row_sq))
    return out.reshape(-1)[:n]


def center_and_flip(points: np.ndarray) -> np.ndarray:
    """Centre the cloud on its centroid and negate z.

    Parity with the reference preprocessing (src/main/splat.cpp:92-100).
    """
    pts = np.asarray(points, np.float32)
    bb_min, bb_max = pts.min(0), pts.max(0)
    pts = pts - (bb_min + bb_max) * 0.5
    pts[:, 2] = -pts[:, 2]
    return pts
