"""Image losses for gaussian-splat training.

The reference is a forward-only renderer (no training loop anywhere in
/root/reference — see SURVEY.md §7 capability gap); the north-star config
adds a training-style iteration. Losses follow the standard 3DGS recipe
(Kerbl et al. 2023): (1-lambda)*L1 + lambda*(1 - SSIM), with SSIM computed
with an 11x11 Gaussian window. Everything is pure jnp, differentiable, and
shape-static so it fuses into the backward XLA program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def l1(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean(jnp.abs(pred - target))


def l2(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean(jnp.square(pred - target))


def psnr(pred: jnp.ndarray, target: jnp.ndarray,
         max_val: float = 1.0) -> jnp.ndarray:
    mse = jnp.mean(jnp.square(pred - target))
    return 10.0 * jnp.log10(max_val * max_val / jnp.maximum(mse, 1e-12))


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float):
    # Pure numpy, not jnp: an lru_cache populated inside a trace would
    # memoise a tracer (leak); a numpy constant is safe across traces.
    import numpy as np
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / np.sum(g)


def _blur(img: jnp.ndarray, window: jnp.ndarray) -> jnp.ndarray:
    """Separable depthwise Gaussian blur of an (H, W, C) image.

    Two rank-1 depthwise convolutions (feature_group_count=C) — small
    convs XLA handles directly; no im2col materialisation.
    """
    c = img.shape[-1]
    x = img[None].transpose(0, 3, 1, 2)  # (1, C, H, W)
    window = jnp.asarray(window)         # cached numpy -> device constant
    kh = jnp.tile(window[None, None, :, None], (c, 1, 1, 1))
    kw = jnp.tile(window[None, None, None, :], (c, 1, 1, 1))
    dn = jax.lax.conv_dimension_numbers(x.shape, kh.shape,
                                        ("NCHW", "OIHW", "NCHW"))
    x = jax.lax.conv_general_dilated(x, kh, (1, 1), "VALID",
                                     dimension_numbers=dn,
                                     feature_group_count=c,
                                     preferred_element_type=jnp.float32)
    x = jax.lax.conv_general_dilated(x, kw, (1, 1), "VALID",
                                     dimension_numbers=dn,
                                     feature_group_count=c,
                                     preferred_element_type=jnp.float32)
    return x[0].transpose(1, 2, 0)


def ssim(pred: jnp.ndarray, target: jnp.ndarray, window_size: int = 11,
         sigma: float = 1.5, max_val: float = 1.0) -> jnp.ndarray:
    """Mean SSIM over an (H, W, C) image pair. Differentiable."""
    w = _gaussian_window(window_size, sigma)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    mu_p = _blur(pred, w)
    mu_t = _blur(target, w)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sig_p = _blur(pred * pred, w) - mu_pp
    sig_t = _blur(target * target, w) - mu_tt
    sig_pt = _blur(pred * target, w) - mu_pt

    num = (2.0 * mu_pt + c1) * (2.0 * sig_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sig_p + sig_t + c2)
    return jnp.mean(num / den)


def dssim(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return 1.0 - ssim(pred, target)


def render_loss(pred: jnp.ndarray, target: jnp.ndarray,
                ssim_weight: float = 0.2) -> jnp.ndarray:
    """Standard 3DGS photometric loss on RGB channels."""
    rgb_p = pred[..., :3]
    rgb_t = target[..., :3]
    loss = (1.0 - ssim_weight) * l1(rgb_p, rgb_t)
    if ssim_weight > 0.0:
        loss = loss + ssim_weight * dssim(rgb_p, rgb_t)
    return loss
