"""Triton rasterize kernels vs the jnp spec, and the choices around them.

On the CPU the kernels run in the Pallas interpreter (platform "cpu");
the `gpu`-marked test compiles them for the card. Also covered here: the
platform -> kernel build choice, the device selection, the compile-cache
placement and the smoke script's last line.
"""

import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splat_ipu_tpu.models.camera import Camera
from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu.render import binning, kernels, tile_raster
from gaussian_splat_ipu_tpu.render.kernels import rasterize
from gaussian_splat_ipu_tpu.render.projection import project_gaussians
from gaussian_splat_ipu_tpu.runtime import engine
from gaussian_splat_ipu_tpu.utils.config import RasterConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = RasterConfig(image_width=64, image_height=64, pair_capacity=1 << 12,
                   max_chunks_per_tile=4)


def _binned(cfg, seed=0, n=600, boost=4.0):
    """A scene dense and opaque enough that early termination engages."""
    m = GaussianModel.random(jax.random.PRNGKey(seed), n)
    m = GaussianModel(m.means, m.log_scales + boost / 8, m.quats,
                      m.opacities + boost, m.sh)
    cam = Camera.orbit(np.array([-1.0, -1.0, -1.0], np.float32),
                       np.array([1.0, 1.0, 1.0], np.float32),
                       fov_radians=np.radians(40.0),
                       aspect=cfg.image_width / cfg.image_height)
    b = binning.bin_splats(project_gaussians(m, cam, cfg), cfg)
    assert int(b.overflow) == 0
    return b


def _grads(b, cfg, raster, seed=11):
    cot = jax.random.normal(jax.random.PRNGKey(seed),
                            (cfg.num_tiles, cfg.pixels_per_tile, 4))
    return np.asarray(jax.grad(lambda f: jnp.sum(
        raster(b._replace(features=f), cfg) * cot))(b.features))


@pytest.mark.parametrize("background", [(0.0, 0.0, 0.0), (0.2, 0.5, 0.9)])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("g", [1, 2])
def test_forward_matches_spec(g, exact, background):
    cfg = dataclasses.replace(CFG, tile_group=g, exact_tile_test=exact,
                              background=background)
    b = _binned(cfg)
    got = np.asarray(rasterize.rasterize_tiles(b, cfg, platform="cpu"))
    spec = np.asarray(tile_raster.rasterize_tiles_jnp(b, cfg))
    assert spec[..., 3].max() > 0.999  # termination engaged somewhere
    np.testing.assert_allclose(got, spec, atol=1e-5)


def test_work_bound_truncates_like_spec():
    """Ranges longer than max_chunks_per_range * chunk_size composite
    only their nearest pairs, in the kernel as in the spec."""
    cfg = dataclasses.replace(CFG, chunk_size=16, max_chunks_per_tile=1)
    b = _binned(cfg, boost=0.0)
    counts = np.asarray(b.tile_ends - b.tile_starts)
    assert counts.max() > cfg.max_chunks_per_range * cfg.chunk_size
    got = np.asarray(rasterize.rasterize_tiles(b, cfg, platform="cpu"))
    spec = np.asarray(tile_raster.rasterize_tiles_jnp(b, cfg))
    np.testing.assert_allclose(got, spec, atol=1e-5)


@pytest.mark.parametrize("g", [1, 2])
def test_backward_matches_spec_autodiff(g):
    """g=1 stores each pair's gradient once; g=2 adds the member tiles'
    shares atomically into a zeroed buffer."""
    cfg = dataclasses.replace(CFG, tile_group=g)
    b = _binned(cfg, seed=4)
    kern = _grads(b, cfg, lambda bb, c: rasterize.rasterize_tiles(
        bb, c, platform="cpu"))
    spec = _grads(b, cfg, tile_raster.rasterize_tiles_jnp)
    np.testing.assert_allclose(kern, spec, atol=2e-4, rtol=1e-3)
    assert np.abs(kern[binning.FEAT_X]).sum() > 0


@pytest.mark.parametrize("g", [1, 2])
def test_backward_rows_near_saturation(g):
    """Each feature row's gradient, against that row's own largest entry,
    where pixels stop at T ~ 1e-4. The backward replays from the final T
    that the forward saved; rebuilt as 1 - alpha, T lost its low bits
    there and rows were off by up to ~1e-4."""
    cfg = dataclasses.replace(CFG, tile_group=g, pair_capacity=1 << 15,
                              max_chunks_per_tile=64)
    with jax.default_matmul_precision("highest"):
        b = _binned(cfg, seed=4, n=2000, boost=8.0)
        spec_t = 1.0 - np.asarray(tile_raster.rasterize_tiles_jnp(b, cfg))
        kern = _grads(b, cfg, lambda bb, c: rasterize.rasterize_tiles(
            bb, c, platform="cpu"))
        ref = _grads(b, cfg, tile_raster.rasterize_tiles_jnp)
    assert spec_t[..., 3].min() < 2e-4
    for r in range(binning.NUM_FEATURES - 1):  # depth has no gradient
        err = np.abs(kern[r] - ref[r]).max()
        assert err <= 1e-5 * np.abs(ref[r]).max(), r


def test_tile_not_a_power_of_two():
    """A 32x20 tile (640 px) runs as a 1024-lane block, the padding
    masked off in both directions."""
    cfg = dataclasses.replace(CFG, image_height=60, tile_height=20)
    b = _binned(cfg, seed=2)
    raster = lambda bb, c: rasterize.rasterize_tiles(bb, c, platform="cpu")
    got = np.asarray(raster(b, cfg))
    spec = np.asarray(tile_raster.rasterize_tiles_jnp(b, cfg))
    np.testing.assert_allclose(got, spec, atol=1e-5)
    np.testing.assert_allclose(
        _grads(b, cfg, raster),
        _grads(b, cfg, tile_raster.rasterize_tiles_jnp),
        atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("platform,interpret",
                         [("gpu", False), ("cpu", True), (None, True)])
def test_kernel_build_per_platform(platform, interpret):
    # None = the process's default backend, the CPU in this suite.
    assert kernels.interpret_for(platform) is interpret


def test_kernel_build_rejects_other_platforms():
    with pytest.raises(ValueError, match="no rasterizer kernel"):
        kernels.interpret_for("rocm")


def test_select_device_never_falls_back():
    with pytest.raises(RuntimeError, match="no GPU"):
        engine.select_device()
    assert engine.select_device(use_cpu_model=True).platform == "cpu"


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(engine.CACHE_ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert engine.enable_compilation_cache("elsewhere") == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv(engine.CACHE_ENV, raising=False)
    assert engine.compile_cache_dir() == str(REPO / ".jax_cache")
    assert engine.compile_cache_dir("mine") == "mine"


def test_smoke_last_line():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()] * 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 3])
def test_compiled_kernels_match_spec(gpu_device, g):
    """The kernels as compiled for the card, forward and gradients."""
    del gpu_device
    cfg = RasterConfig(image_width=320, image_height=192,
                       pair_capacity=1 << 16, tile_group=g,
                       exact_tile_test=True)
    with jax.default_matmul_precision("highest"):
        b = _binned(cfg, n=4000, boost=0.0)
        got = np.asarray(rasterize.rasterize_tiles(b, cfg, platform="gpu"))
        spec = np.asarray(tile_raster.rasterize_tiles_jnp(b, cfg))
        np.testing.assert_allclose(got, spec, atol=1e-5)
        kern = _grads(b, cfg, lambda bb, c: rasterize.rasterize_tiles(
            bb, c, platform="gpu"))
        ref = _grads(b, cfg, tile_raster.rasterize_tiles_jnp)
    for r in range(binning.NUM_FEATURES - 1):
        err = np.abs(kern[r] - ref[r]).max()
        assert err <= 1e-4 * max(np.abs(ref[r]).max(), 1e-30), r

