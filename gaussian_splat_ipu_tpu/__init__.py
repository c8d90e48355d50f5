"""gaussian_splat_ipu_tpu — differentiable 3D gaussian splatting framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
Nmjfry/gaussian_splat_ipu (a C++/Poplar IPU splat render server), extended
per the north star to a differentiable, multi-device renderer + trainer.

Public surface (lazily imported to keep `import gaussian_splat_ipu_tpu`
free of JAX initialisation side effects):

  models    GaussianModel, Camera
  render    render / render_image (project -> bin -> Pallas rasterize),
            render_oracle (dense spec), render_points (1-px sanity path)
  io        load_scene, Scene
  train     TrainConfig, TrainState, train_step, fit, losses, checkpoint
  parallel  make_mesh, shard_model, render_sharded, make_sharded_train_step
  runtime   RenderEngine, setup_logging
  utils     RasterConfig, RuntimeConfig, profiling, image
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "GaussianModel": "gaussian_splat_ipu_tpu.models.gaussians",
    "Camera": "gaussian_splat_ipu_tpu.models.camera",
    "RasterConfig": "gaussian_splat_ipu_tpu.utils.config",
    "RuntimeConfig": "gaussian_splat_ipu_tpu.utils.config",
    "render": "gaussian_splat_ipu_tpu.render.pipeline",
    "render_image": "gaussian_splat_ipu_tpu.render.pipeline",
    "render_depth": "gaussian_splat_ipu_tpu.render.pipeline",
    "load_scene": "gaussian_splat_ipu_tpu.io.scene",
    "Scene": "gaussian_splat_ipu_tpu.io.scene",
    "load_transforms": "gaussian_splat_ipu_tpu.io.dataset",
    "load_colmap": "gaussian_splat_ipu_tpu.io.colmap",
    "FrameSet": "gaussian_splat_ipu_tpu.io.dataset",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(module), name)
