"""Adaptive density control: split / clone / prune gaussians during
training (the 3DGS densification mechanism, Kerbl et al. 2023 §5.2).

The reference is forward-only and has nothing like this (SURVEY.md §7 —
training is the north-star extension); this module supplies it in a
fully static-shape form that compiles once:

- The model lives in a FIXED-CAPACITY buffer of `capacity` slots plus an
  `alive` mask; split/clone children are scattered into free (dead) slots
  and pruning just clears the mask, so every step and every densify event
  compiles once and reuses the same executable — no recompile as the
  gaussian count changes (XLA static shapes; growing capacity is a
  host-side `pad_to` + one recompile, `grow_capacity`).
- Screen-space positional gradients (the densification signal) come from
  a zero-valued probe added to the projected xy
  (render/projection.py::xy_probe): d(loss)/d(probe) is exactly
  d(loss)/d(pixel position) per gaussian, accumulated in NDC-equivalent
  units so the standard 2e-4 threshold applies at any resolution.
- Slot allocation is a rank-and-scatter: birth candidates are ordered by
  accumulated gradient (argsort), free slots are enumerated with a stable
  argsort of the keep mask, and candidate b lands in free slot b while
  b < min(births, free) — the same bounded-capacity + graceful-drop
  discipline as the reference's fixed 300-record exchange channels
  (src/splat/ipu_rasteriser.cpp:307-309): lowest-priority births are
  dropped, never an overflow.
- Optimizer state is repaired row-wise: Adam moments of new / re-sampled /
  pruned rows are zeroed in-place via a shape-matched tree_map over the
  optax state (standard 3DGS rebuilds the optimizer tensors; zeroing the
  rows is the static-shape equivalent).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu.ops.transforms import quat_to_rotmat
from gaussian_splat_ipu_tpu.render.pipeline import render
from gaussian_splat_ipu_tpu.train import losses, trainer
from gaussian_splat_ipu_tpu.utils.config import RasterConfig

# Raw-opacity / log-scale fill for dead slots: sigmoid(-30) ~ 9e-14 is far
# below any alpha_min so dead slots are frustum-culled at projection time.
_DEAD_OPACITY = -30.0
_DEAD_LOG_SCALE = -30.0


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """Hashable (static under jit) density-control hyper-parameters."""

    # Average NDC-units screen gradient above which a gaussian densifies
    # (standard 3DGS densify_grad_threshold).
    grad_threshold: float = 2e-4
    # Split when max world scale > percent_dense * scene_extent, else clone.
    percent_dense: float = 0.01
    # Prune when post-sigmoid opacity falls below this.
    min_opacity: float = 0.005
    # Prune when max world scale exceeds this fraction of the scene extent
    # (0 disables; standard 3DGS enables 0.1 after opacity resets begin).
    max_world_scale: float = 0.0
    # Each split child's scales shrink by this factor.
    split_scale_factor: float = 1.6
    scene_extent: float = 1.0
    # Cadence (consumed by fit_densify / app.train, not by the kernels).
    densify_every: int = 100
    densify_from_step: int = 500
    densify_until_step: int = 15_000
    reset_opacity_every: int = 3_000
    # Opacity ceiling applied at reset events (pre-sigmoid value of 0.01).
    reset_opacity_to: float = 0.01


class DensifyState(NamedTuple):
    """Per-slot densification statistics (a pytree carried in training)."""

    grad_sum: jnp.ndarray   # (C,) f32 accumulated NDC screen-grad norms
    vis_count: jnp.ndarray  # (C,) i32 frames the gaussian was visible
    alive: jnp.ndarray      # (C,) bool slot occupancy
    key: jnp.ndarray        # PRNG key for split sampling


def init_state(num_alive: int, capacity: int, key=None) -> DensifyState:
    if key is None:
        key = jax.random.PRNGKey(0)
    if num_alive > capacity:
        raise ValueError(f"{num_alive} gaussians > capacity {capacity}")
    return DensifyState(
        grad_sum=jnp.zeros((capacity,), jnp.float32),
        vis_count=jnp.zeros((capacity,), jnp.int32),
        alive=jnp.arange(capacity) < num_alive,
        key=key,
    )


def pad_model(model: GaussianModel, capacity: int) -> GaussianModel:
    """Pad a model into its fixed-capacity training buffer."""
    padded = model.pad_to(capacity)
    return GaussianModel(
        means=padded.means, log_scales=padded.log_scales,
        quats=padded.quats,
        opacities=jnp.where(jnp.arange(capacity) < model.num_gaussians,
                            padded.opacities, _DEAD_OPACITY),
        sh=padded.sh)


def grow_capacity(state: "trainer.TrainState", dstate: DensifyState,
                  new_capacity: int):
    """Host-side capacity growth: pad the slot buffer (params, optimizer
    moments, stats) with dead slots at the end. The one operation that
    changes shapes — every subsequent step/event recompiles once for the
    new capacity and is static again.
    """
    old = dstate.alive.shape[0]
    if new_capacity < old:
        raise ValueError(f"new capacity {new_capacity} < current {old}")
    if new_capacity == old:
        return state, dstate
    params = pad_model(state.params, new_capacity)
    pad = new_capacity - old

    def pad_rows(leaf):
        if (isinstance(leaf, jnp.ndarray) and leaf.ndim >= 1
                and leaf.shape[0] == old):
            widths = [(0, pad)] + [(0, 0)] * (leaf.ndim - 1)
            return jnp.pad(leaf, widths)
        return leaf

    opt_state = jax.tree.map(pad_rows, state.opt_state)
    new_state = trainer.TrainState(params=params, opt_state=opt_state,
                                   step=state.step)
    new_dstate = DensifyState(
        grad_sum=jnp.pad(dstate.grad_sum, (0, pad)),
        vis_count=jnp.pad(dstate.vis_count, (0, pad)),
        alive=jnp.pad(dstate.alive, (0, pad)),
        key=dstate.key)
    return new_state, new_dstate


def compact(model: GaussianModel, dstate: DensifyState) -> GaussianModel:
    """Host-side: drop dead slots (e.g. before checkpointing / rendering).

    Not jittable (data-dependent output shape).
    """
    idx = jnp.nonzero(dstate.alive)[0]
    return jax.tree.map(lambda x: x[idx], model)


# ---------------------------------------------------------------------------
# Training step with gradient-statistics accumulation
# ---------------------------------------------------------------------------

def loss_mix_scale(model: GaussianModel, camera: Camera,
                   target: jnp.ndarray, raster_cfg: RasterConfig,
                   ssim_weight: float, use_pallas: bool = False) -> float:
    """Screen-gradient scale of the (1-w)*L1 + w*DSSIM mix, relative to
    pure L1 — the normalisation that keeps DensifyConfig.grad_threshold
    (calibrated on L1, the standard 2e-4) meaningful at any ssim_weight.

    DSSIM's per-pixel gradients are an order of magnitude larger than
    L1's (they are variance-normalised), so probe gradients grow nearly
    linearly in the mix: measured on held scenes,
    mean_grad(w) ~ (1-w)*gL1 + w*gSSIM with gSSIM/gL1 ~ 15-20 but
    scene-dependent — hence this MEASURES the ratio on the actual scene
    (two extra backward passes, once per run) instead of hard-coding it.
    Callers multiply grad_threshold by the returned scale (= 1 at w=0).
    """
    if ssim_weight <= 0.0:
        return 1.0
    half_wh = jnp.array([0.5 * raster_cfg.image_width,
                         0.5 * raster_cfg.image_height], jnp.float32)

    def mean_gnorm(loss_img_fn):
        def loss_fn(probe):
            out = render(model, camera, raster_cfg, use_pallas,
                         xy_probe=probe)
            return loss_img_fn(out.image), out.visible
        probe = jnp.zeros((model.num_gaussians, 2), jnp.float32)
        g, vis = jax.grad(loss_fn, has_aux=True)(probe)
        gn = jnp.linalg.norm(g * half_wh[None, :], axis=-1)
        denom = jnp.maximum(jnp.sum(vis.astype(jnp.float32)), 1.0)
        return jnp.sum(jnp.where(vis, gn, 0.0)) / denom

    g_l1 = float(mean_gnorm(
        lambda im: losses.l1(im[..., :3], target[..., :3])))
    g_ssim = float(mean_gnorm(
        lambda im: losses.dssim(im[..., :3], target[..., :3])))
    alpha = g_ssim / max(g_l1, 1e-12)
    return (1.0 - ssim_weight) + ssim_weight * alpha


def make_train_step(raster_cfg: RasterConfig, train_cfg: trainer.TrainConfig,
                    use_pallas: bool = True, jit: bool = True,
                    depth_weight: float = 0.0):
    """Train step that also accumulates densification statistics.

    step(state, dstate, camera, target) -> (state, dstate, loss). The probe
    gradient costs one extra (C, 2) zeros input; everything else is the
    plain trainer.train_step computation. jit=False returns the raw
    traceable function (for embedding in a caller's lax.scan epoch).

    With depth_weight > 0 the step instead takes
    (state, dstate, camera, target, obs, mask) and adds the sparse SfM
    depth term (train/depth.py) — depth-regularised density control, the
    standard real-capture recipe.
    """
    tx = trainer.make_optimizer(train_cfg)
    if depth_weight > 0.0:
        from gaussian_splat_ipu_tpu.train import depth as depth_mod

    def loss_fn(params, probe, camera, target, obs=None, mask=None):
        out = render(params, camera, raster_cfg, use_pallas, xy_probe=probe)
        loss = losses.render_loss(out.image, target,
                                  train_cfg.ssim_weight)
        if depth_weight > 0.0:
            loss = loss + depth_weight * depth_mod.sparse_depth_loss(
                params, camera, obs, mask, raster_cfg, use_pallas)
        return (loss, out.visible)

    half_wh = jnp.array([0.5 * raster_cfg.image_width,
                         0.5 * raster_cfg.image_height], jnp.float32)

    def step(state: trainer.TrainState, dstate: DensifyState,
             camera: Camera, target: jnp.ndarray, obs=None, mask=None):
        probe = jnp.zeros((state.params.num_gaussians, 2), jnp.float32)
        (loss, visible), (grads, gxy) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(
            state.params, probe, camera, target, obs, mask)

        # d(pixel xy) -> NDC-equivalent units so the standard threshold
        # holds at any resolution: xy_px = (ndc + 1) * (wh / 2).
        gnorm = jnp.linalg.norm(gxy * half_wh[None, :], axis=-1)
        dstate = DensifyState(
            grad_sum=dstate.grad_sum + jnp.where(visible, gnorm, 0.0),
            vis_count=dstate.vis_count + visible.astype(jnp.int32),
            alive=dstate.alive, key=dstate.key)

        params, opt_state = trainer.apply_param_updates(
            tx, state.params, grads, state.opt_state)
        return trainer.TrainState(params=params, opt_state=opt_state,
                                  step=state.step + 1), dstate, loss

    if jit:
        return jax.jit(step, donate_argnums=(0, 1))
    return step


# ---------------------------------------------------------------------------
# The densify / prune event
# ---------------------------------------------------------------------------

def _reset_rows(opt_state, row_mask: jnp.ndarray):
    """Zero optimizer-state rows (Adam moments) for masked slots.

    Any array leaf whose leading dimension equals the slot count is treated
    as per-gaussian state; scalars (Adam step counts, schedule counters) and
    optax MaskedNode sentinels pass through untouched.
    """
    c = row_mask.shape[0]

    def f(leaf):
        if (isinstance(leaf, jnp.ndarray) and leaf.ndim >= 1
                and leaf.shape[0] == c):
            m = row_mask.reshape((c,) + (1,) * (leaf.ndim - 1))
            return jnp.where(m, jnp.zeros_like(leaf), leaf)
        return leaf

    return jax.tree.map(f, opt_state)


def _scatter_rows(x: jnp.ndarray, slots: jnp.ndarray, values: jnp.ndarray,
                  mask: jnp.ndarray) -> jnp.ndarray:
    """x[slots[i]] = values[i] where mask[i]; slots unique."""
    m = mask.reshape((-1,) + (1,) * (x.ndim - 1))
    return x.at[slots].set(jnp.where(m, values, x[slots]))


@functools.partial(jax.jit, static_argnums=(2,))
def densify_and_prune(state: trainer.TrainState, dstate: DensifyState,
                      cfg: DensifyConfig = DensifyConfig()
                      ) -> Tuple[trainer.TrainState, DensifyState]:
    """One density-control event. Static shapes: capacity never changes;
    children land in free slots, lowest-priority births drop when full."""
    params, opt_state = state.params, state.opt_state
    capacity = params.num_gaussians
    alive = dstate.alive

    avg = dstate.grad_sum / jnp.maximum(dstate.vis_count, 1).astype(
        jnp.float32)
    scales = jnp.exp(params.log_scales)
    smax = jnp.max(scales, axis=-1)
    ext = cfg.scene_extent

    candidate = alive & (avg > cfg.grad_threshold)
    is_split = candidate & (smax > cfg.percent_dense * ext)
    is_clone = candidate & ~is_split

    opacity = jax.nn.sigmoid(params.opacities)
    prune = opacity < cfg.min_opacity
    if cfg.max_world_scale > 0.0:
        prune = prune | (smax > cfg.max_world_scale * ext)
    keep = alive & ~prune
    is_split = is_split & keep
    is_clone = is_clone & keep

    # -- split: parent slot becomes child A (sampled inside the parent's
    # footprint, shrunk scales); child B goes to a free slot. ------------
    k_next, ka, kb = jax.random.split(dstate.key, 3)
    rot = quat_to_rotmat(params.quats)                      # (C, 3, 3)

    def sample(k):
        eps = jax.random.normal(k, (capacity, 3), jnp.float32)
        return params.means + jnp.einsum("nij,nj->ni", rot, scales * eps)

    mean_a, mean_b = sample(ka), sample(kb)
    shrunk = params.log_scales - jnp.log(cfg.split_scale_factor)

    split3 = is_split[:, None]
    means = jnp.where(split3, mean_a, params.means)
    log_scales = jnp.where(split3, shrunk, params.log_scales)

    # -- births: split child B (sampled mean, shrunk scales) or clone copy
    # (exact duplicate; Adam separates them in subsequent steps). --------
    birth = is_split | is_clone
    birth_model = GaussianModel(
        means=jnp.where(split3, mean_b, params.means),
        log_scales=log_scales,
        quats=params.quats, opacities=params.opacities, sh=params.sh)

    # Rank births by accumulated gradient; enumerate free slots stably.
    order = jnp.argsort(jnp.where(birth, -avg, jnp.inf), stable=True)
    free_slots = jnp.argsort(keep, stable=True)   # False (free) first
    n_birth = jnp.sum(birth)
    n_free = capacity - jnp.sum(keep)
    placed = jnp.arange(capacity) < jnp.minimum(n_birth, n_free)

    def place(x, values):
        return _scatter_rows(x, free_slots, values[order], placed)

    new_params = GaussianModel(
        means=place(means, birth_model.means),
        log_scales=place(log_scales, birth_model.log_scales),
        quats=place(params.quats, birth_model.quats),
        opacities=place(params.opacities, birth_model.opacities),
        sh=place(params.sh, birth_model.sh))

    alive_new = _scatter_rows(keep, free_slots,
                              jnp.ones((capacity,), bool), placed)

    # Dead-slot hygiene: park pruned/unused slots out of every frustum.
    dead = ~alive_new
    new_params = GaussianModel(
        means=new_params.means,
        log_scales=jnp.where(dead[:, None], _DEAD_LOG_SCALE,
                             new_params.log_scales),
        quats=new_params.quats,
        opacities=jnp.where(dead, _DEAD_OPACITY, new_params.opacities),
        sh=new_params.sh)

    # Adam moments: zero rows that changed meaning (split parents, all
    # birth slots, dead slots).
    touched = is_split | dead
    touched = _scatter_rows(touched, free_slots,
                            jnp.ones((capacity,), bool), placed)
    new_opt = _reset_rows(opt_state, touched)

    return (trainer.TrainState(params=new_params, opt_state=new_opt,
                               step=state.step),
            DensifyState(grad_sum=jnp.zeros_like(dstate.grad_sum),
                         vis_count=jnp.zeros_like(dstate.vis_count),
                         alive=alive_new, key=k_next))


@functools.partial(jax.jit, static_argnums=(2,))
def reset_opacity(state: trainer.TrainState, dstate: DensifyState,
                  cfg: DensifyConfig = DensifyConfig()
                  ) -> trainer.TrainState:
    """Clamp every live opacity to at most `reset_opacity_to` (post-sigmoid)
    and zero the opacity Adam moments — the periodic reset that lets
    pruning clear floaters (3DGS §5.2)."""
    p = cfg.reset_opacity_to
    ceiling = jnp.log(p / (1.0 - p))  # logit
    params = state.params
    new_op = jnp.where(dstate.alive,
                       jnp.minimum(params.opacities, ceiling),
                       params.opacities)

    def f(leaf):
        if (isinstance(leaf, jnp.ndarray) and leaf.ndim == 1
            and leaf.shape[0] == new_op.shape[0]):
            return jnp.zeros_like(leaf)
        return leaf

    # Only the opacity label's moments are 1-D of length C; other families
    # are (C, k) and untouched by ndim==1 matching.
    new_opt = jax.tree.map(f, state.opt_state)
    return trainer.TrainState(
        params=GaussianModel(means=params.means,
                             log_scales=params.log_scales,
                             quats=params.quats, opacities=new_op,
                             sh=params.sh),
        opt_state=new_opt, step=state.step)


# ---------------------------------------------------------------------------
# Convenience fit loop
# ---------------------------------------------------------------------------

def fit_densify(model: GaussianModel, cameras, targets,
                raster_cfg: RasterConfig,
                train_cfg: trainer.TrainConfig = trainer.TrainConfig(),
                densify_cfg: DensifyConfig = DensifyConfig(),
                capacity: Optional[int] = None, num_steps: int = 1000,
                use_pallas: bool = True, key=None, log_every: int = 0):
    """Single-device training loop with density control.

    Returns (compacted model, history list of (step, loss, alive)).
    """
    n0 = model.num_gaussians
    if capacity is None:
        capacity = max(2 * n0, 1024)
    if train_cfg.ssim_weight > 0.0:
        # Keep the L1-calibrated grad_threshold meaningful under an
        # SSIM-weighted loss (otherwise densification over-grows: SSIM
        # probe gradients are ~15-20x L1's).
        scale = loss_mix_scale(model, cameras[0], targets[0], raster_cfg,
                               train_cfg.ssim_weight, use_pallas)
        densify_cfg = dataclasses.replace(
            densify_cfg,
            grad_threshold=densify_cfg.grad_threshold * scale)
    dstate = init_state(n0, capacity, key)
    state = trainer.init_state(pad_model(model, capacity), train_cfg)
    step = make_train_step(raster_cfg, train_cfg, use_pallas)

    history = []
    n_views = len(cameras)
    c = densify_cfg
    for i in range(num_steps):
        state, dstate, loss = step(state, dstate, cameras[i % n_views],
                                   targets[i % n_views])
        it = i + 1
        if (c.densify_from_step <= it <= c.densify_until_step
                and it % c.densify_every == 0):
            state, dstate = densify_and_prune(state, dstate, c)
        # Reset only while densification continues AND with recovery room
        # before the end: a reset on the final steps returns a
        # near-transparent model (3DGS resets every 3k only during the
        # densification phase).
        if (c.reset_opacity_every and it % c.reset_opacity_every == 0
                and it <= min(num_steps - 500, c.densify_until_step)):
            state = reset_opacity(state, dstate, c)
        if log_every and (i % log_every == 0 or i == num_steps - 1):
            history.append((i, float(loss),
                            int(jnp.sum(dstate.alive))))
    return compact(state.params, dstate), history
