"""Framework configuration.

The reference hard-codes image/tile geometry as compile-time #defines
(reference: include/tileMapping/tile_config.hpp:5-15) and exposes runtime
behaviour through a RuntimeConfig struct (include/ipu/ipu_utils.hpp:174-183).
Here both become proper dataclass configs: geometry is a runtime parameter of
the pipeline (static under jit via hashable dataclasses), and all capacities
that the reference fixes in silicon (framebuffer tiling, exchange-channel
sizes) become tunable fields.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Reference workload constants (tile_config.hpp:5-15): 1280x720 image split
# into 40x36 = 1440 tiles of 32x20 px. Here a tile is one kernel block of
# pixels, padded to a power of two; the default 32x32 = 1024 px needs no
# padding.
DEFAULT_IMAGE_WIDTH = 1280
DEFAULT_IMAGE_HEIGHT = 720


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static configuration of the tiled rasterizer.

    Frozen + hashable so it can be a static argument under jax.jit.
    """

    image_width: int = DEFAULT_IMAGE_WIDTH
    image_height: int = DEFAULT_IMAGE_HEIGHT
    # 32x32 px = 1024 px per tile: one power-of-two kernel block.
    tile_width: int = 32
    tile_height: int = 32
    # The jnp spec composites gaussians in chunks of this many (one cumprod
    # per chunk); the per-range work bound below counts in chunks too.
    chunk_size: int = 128
    # Capacity of the (gaussian, tile) pair table. The reference bounds the
    # analogous resource with fixed 300-slot exchange channels and a
    # keep-local overflow policy (src/splat/ipu_rasteriser.cpp:307-309,
    # codelets.cpp:487-490); we bound the pair table and drop+count
    # overflow (RenderOutput.overflow — raise this when it is nonzero).
    # Every binning pass is O(capacity), so headroom costs frame time
    # linearly; 2^18 is ~2.6x the worst observed demand on the reference
    # demo scenes at 1280x720.
    pair_capacity: int = 1 << 18
    # Max tiles a single gaussian may cover per axis (guard band). The
    # reference caps footprints at clipSize=15 tile diagonals
    # (codelets/splat/codelets.cpp:622,470).
    max_tiles_per_axis: int = 16
    # Max chunks any one tile will composite (bounds per-tile work in BOTH
    # the kernel and the jnp spec — they truncate identically).
    max_chunks_per_tile: int = 128
    # Early termination threshold on transmittance, reference
    # codelets.cpp:405-408.
    transmittance_eps: float = 1e-4
    # Alpha handling, reference codelets.cpp:400-403.
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    # EWA low-pass filter added to the 2D covariance diagonal, reference
    # include/splat/ipu_geometry.hpp:377-378.
    lowpass: float = 0.3
    # Antialiasing: scale opacity by sqrt(det(cov)/det(cov + lowpass)) so
    # the lowpass dilation conserves each splat's energy instead of
    # brightening sub-pixel splats (Mip-Splatting, Yu et al. CVPR 2024).
    antialias: bool = False
    # Background color composited behind the splats.
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Apply sigmoid to raw opacity (standard 3DGS). The reference feeds the
    # PLY logit straight through (src/main/splat.cpp:149); set False for
    # bug-for-bug parity experiments.
    sigmoid_opacity: bool = True
    # Pack (tile, depth) into ONE i32 radix key: the depth keeps
    # 31 - ceil(log2(num_tiles + 2)) bits of its (order-isomorphic) f32 bit
    # pattern — 21 bits at 720p, i.e. 8 exponent + 13 mantissa bits, a
    # relative depth resolution of ~1e-4. One sort pass instead of two.
    # Compositing order can differ from
    # the exact sort only for gaussians closer together than that
    # resolution; set False for the exact two-pass (tile, full-depth) sort.
    fused_sort_key: bool = True
    # Depth-presort binning: sort the N gaussians by depth once (cheap —
    # N << P pairs), expand pairs in depth order, then bin with a
    # TILE-ONLY single-key sort (stability preserves the depth order
    # within each tile). The P-wide sort then carries a small-range key
    # instead of (tile | depth) bits, and the depth ordering is EXACT
    # (full 31-bit f32 order, unlike the quantized fused key). Requires
    # fused_sort_key machinery; falls back to it when the tile-bit budget
    # doesn't fit.
    presort_depth: bool = False
    # Splat footprint bound in sigmas. Extents are alpha-aware (the box
    # stops where alpha drops below alpha_min — dim splats enumerate far
    # fewer tiles at identical output) and this caps them at the classic
    # 3-sigma square. 0.0 = uncapped: footprints reach the full alpha_min
    # radius (~3.33 sigma for opaque splats) and the tiled pipeline is
    # then pixel-exact vs the dense oracle at ~10% more pairs.
    extent_sigma: float = 3.0
    # Exact tile-ellipse intersection test during binning. The rectangle
    # enumeration keeps every tile of the footprint's bounding box; a
    # splat's ellipse misses many corner tiles of that box (each missed
    # tile = one dead (gaussian, tile) pair through every O(P) binning
    # pass AND a full compositing pass over 1024 pixels). With this on,
    # each gaussian builds a 64-bit coverage mask over (up to) an 8x8
    # tile window by minimising the conic quadratic over each tile's
    # pixel rectangle; only tiles where some pixel can clear alpha_min
    # are enumerated, so the output is pixel-identical. Footprints wider
    # than 8 tiles on either axis keep the full rectangle. Composes with
    # tile_group: the mask is then evaluated over g x g-tile GROUP cells
    # (the window spans 8g tiles per axis), cutting corner groups the
    # same way.
    exact_tile_test: bool = False
    # Tile-GROUP binning (GS-TG-style redundant-sort reduction,
    # arxiv 2509.00911): bin and depth-sort (gaussian, GROUP) pairs over
    # tile_group x tile_group super-tiles instead of per-tile pairs; each
    # tile composites its group's range. A splat spanning k tiles inside
    # one group costs ONE pair instead of k, shrinking every O(P) binning
    # pass and the dominant radix sort; non-covering splats evaluate to
    # alpha < alpha_min in the compositor and are skipped, so with
    # alpha-aware extents (extent_sigma=0) the image is pixel-identical.
    # Compositing reads each group range once per member tile (more reads);
    # profitable when the frame is sort-bound (1M+ gaussians). 1 = off.
    # Composes with exact_tile_test (group-cell coverage masks). Works on
    # the distributed row-strip path when each device's strip covers
    # whole group rows (rows-per-device % tile_group == 0).
    tile_group: int = 1
    # Cap the SH band actually evaluated (-1 = the model's full degree).
    # Training schedules raise this progressively (standard 3DGS: one band
    # per 1000 iterations) — it is static, so each bump recompiles once.
    active_sh_degree: int = -1

    @property
    def max_chunks_per_range(self) -> int:
        """Per-RANGE compositing work bound. With tile grouping a tile's
        range is its whole group's (up to tile_group^2 tiles of pairs),
        so the cap scales accordingly — otherwise grouping would silently
        divide the effective per-tile capacity by g^2."""
        return self.max_chunks_per_tile * self.tile_group * self.tile_group

    @property
    def tiles_x(self) -> int:
        return -(-self.image_width // self.tile_width)

    @property
    def tiles_y(self) -> int:
        return -(-self.image_height // self.tile_height)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile_width

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile_height

    @property
    def pixels_per_tile(self) -> int:
        return self.tile_width * self.tile_height


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Runtime behaviour knobs, the analogue of the reference RuntimeConfig
    (include/ipu/ipu_utils.hpp:174-183). numIpus/numReplicas become the
    device mesh shape; saveExe/loadExe become the persistent XLA compilation
    cache; useIpuModel becomes the CPU path (kernels interpreted).
    """

    num_devices: int = 1
    exe_name: str = "gsplat"
    use_cpu_model: bool = False  # analogue of useIpuModel
    compile_cache_dir: str = ""  # analogue of saveExe/loadExe
    compile_only: bool = False
    donate_buffers: bool = True
