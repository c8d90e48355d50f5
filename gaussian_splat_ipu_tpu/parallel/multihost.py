"""Multi-host (multi-process) setup.

The reference is strictly single-process/single-IPU (SURVEY.md §4: "no
multi-IPU or multi-host code paths exist"); the north star requires N>=2
host scaling. JAX's model: one process per host, `jax.distributed`
bootstraps the cluster, `jax.devices()` then spans every host and the SAME
shard_map code from parallel/distributed.py runs unchanged — XLA hands the
collectives to NCCL, over NVLink within a host and the network across
hosts.

Typical launch (one command per host):

    python -m gaussian_splat_ipu_tpu.app.train --input scene.ply \
        --distributed   # after initialize() via GSPLAT_COORDINATOR env

Environment contract (nothing on a plain GPU host describes the cluster):
    GSPLAT_COORDINATOR  host:port of process 0
    GSPLAT_NUM_PROCESSES, GSPLAT_PROCESS_ID
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import jax

log = logging.getLogger("gsplat")


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Bootstrap jax.distributed from args or GSPLAT_* env vars.

    Returns True when a multi-process cluster was initialised, False for
    the single-process fallback (no env set). Idempotent.
    """
    coordinator = coordinator or os.environ.get("GSPLAT_COORDINATOR")
    if coordinator is None:
        # No coordinator given: a single-process run, left untouched.
        return False
    num_processes = num_processes or int(
        os.environ.get("GSPLAT_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("GSPLAT_PROCESS_ID", "0"))
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    log.info("distributed: process %d/%d, %d global devices",
             process_id, num_processes, len(jax.devices()))
    return True


def is_primary() -> bool:
    """True on the process that should write checkpoints/logs."""
    return jax.process_index() == 0


def local_shard_bounds(n: int) -> tuple:
    """[lo, hi) of the gaussian axis owned by this process's devices,
    for loading only the local slice of a huge scene from disk."""
    nproc = jax.process_count()
    per = -(-n // nproc)
    lo = jax.process_index() * per
    return lo, min(lo + per, n)


def load_scene_sharded(path: str, mesh, axis: str = "shard",
                       center: bool = True, flip_z: bool = True,
                       sh_degree: int = 0):
    """Load a scene with each process parsing ONLY its own row slice.

    The per-process IO cost scales with the shard, not the file (config-5
    scale: a 10M-gaussian PLY never fully materialises on any one host).
    Mechanics:

      1. header-only vertex count (io/ply.count_vertices);
      2. this process reads rows [lo, hi) via the seek-based
         vertex_range reader (io/ply.read_ply);
      3. the world centre must be GLOBAL for consistent centring, so
         per-process raw bboxes are exchanged (process_allgather — one
         (2,3) f32 per host over DCN) before assembly;
      4. leaves become one global jax.Array from per-process local data
         (make_array_from_process_local_data), sharded P(axis) on `mesh`
         — exactly what render_sharded/make_sharded_train_step expect.

    Single-process: degenerates to load_scene + shard_model semantics.
    The reference's loader story is single-host
    (/root/reference/src/splat/file_io.cpp:30-77); this is its north-star
    extension (VERDICT r1 next-step #6).
    """
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gaussian_splat_ipu_tpu.io import ply as ply_io
    from gaussian_splat_ipu_tpu.io import scene as scene_lib

    nproc = jax.process_count()
    d_total = int(np.prod(list(mesh.shape.values()))) if hasattr(
        mesh, "shape") else len(jax.devices())
    ext = path.rsplit(".", 1)[-1].lower()
    if ext not in ("ply", "splat") or nproc == 1:
        # xyz files and single-process runs: plain full load, then place.
        scene = scene_lib.load_scene(path, center, flip_z, sh_degree)
        from gaussian_splat_ipu_tpu.parallel import mesh as meshlib
        scene.model = meshlib.shard_model(scene.model, mesh, axis)
        return scene

    if ext == "splat":
        from gaussian_splat_ipu_tpu.io import splat as splat_io
        n = splat_io.count_records(path)
    else:
        n = ply_io.count_vertices(path)
    # Row geometry must match the mesh sharding exactly: pad N to a
    # multiple of the device count, give each process an equal run of
    # device shards (processes own contiguous device ranges in
    # jax.devices() order).
    n_pad = -(-n // d_total) * d_total
    per_proc = n_pad // nproc
    # A pure-padding process (tiny scene, many hosts) must clamp BOTH
    # bounds: lo > n would hand read_ply a negative-length range.
    lo = min(jax.process_index() * per_proc, n)
    hi = min(lo + per_proc, n)

    fields = ply_io.load_points(path, row_range=(lo, hi))
    raw_means = fields["means"].astype(np.float32)
    if raw_means.shape[0]:
        local_bb = np.stack([raw_means.min(0), raw_means.max(0)])
    else:  # a pure-padding process (tiny scene, many hosts)
        local_bb = np.stack([np.full(3, np.inf, np.float32),
                             np.full(3, -np.inf, np.float32)])

    from jax.experimental import multihost_utils
    all_bb = np.asarray(multihost_utils.process_allgather(local_bb))
    all_bb = all_bb.reshape(-1, 2, 3)
    bb_min, bb_max = all_bb[:, 0].min(0), all_bb[:, 1].max(0)
    center_point = (bb_min + bb_max) * 0.5 if center else None

    scene = scene_lib.assemble_scene(fields, center, flip_z, sh_degree,
                                     center_point=center_point)
    model = scene.model
    if hi - lo < per_proc:
        model = model.pad_to(per_proc)

    def to_global(x):
        spec = P(*([axis] + [None] * (x.ndim - 1)))
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), np.asarray(x))

    scene.model = jax.tree.map(to_global, model)
    # Scene bounds: global post-transform bbox (pads excluded — they were
    # appended after assembly).
    post_bb = np.stack([
        np.asarray(scene.bb_min, np.float32),
        np.asarray(scene.bb_max, np.float32)])
    if hi <= lo:
        post_bb = np.stack([np.full(3, np.inf, np.float32),
                            np.full(3, -np.inf, np.float32)])
    all_post = np.asarray(
        multihost_utils.process_allgather(post_bb)).reshape(-1, 2, 3)
    scene.bb_min = all_post[:, 0].min(0)
    scene.bb_max = all_post[:, 1].max(0)
    return scene


def export_ply_sharded(path: str, model) -> None:
    """Write a globally-sharded GaussianModel as ONE standard 3DGS PLY,
    each process writing only its own row slice.

    The symmetric operation to load_scene_sharded: at config-5 scale
    (10M+ gaussians) the trained model never fits a single host, so the
    primary-gather export (app/train.py host_tree) is replaced by
    positional writes — the header is a pure function of (columns, N), so
    every process computes the same byte offsets and pwrites its rows at
    header_len + lo * record_size. Requires `path` on a filesystem all
    processes share (NFS/GCS-fuse pod setups); single-process it
    degenerates to a plain export. Padding rows (opacity -30, from
    shard_model's round-up) are exported as-is: they are invisible by
    construction and reference loaders render them as nothing.

    Reference: extends /root/reference/src/splat/file_io.cpp (single-host
    loader, no writer existed) per the north-star scaling story.
    """
    import numpy as np

    from gaussian_splat_ipu_tpu.io import ply as ply_io
    from gaussian_splat_ipu_tpu.train import checkpoint

    def local_rows(x):
        if not isinstance(x, jax.Array) or not hasattr(x, "sharding"):
            return 0, np.asarray(x)
        shards = sorted(x.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        lo = shards[0].index[0].start or 0
        data = np.concatenate([np.asarray(s.data) for s in shards], 0)
        # The gaussian axis must be contiguous per process (the mesh
        # construction orders devices process-major, parallel/mesh.py).
        hi = shards[-1].index[0].stop
        hi = data.shape[0] + lo if hi is None else hi
        assert hi - lo == data.shape[0], (
            "process's row shards are not contiguous; cannot pwrite")
        return lo, data

    n_total = jax.tree_util.tree_leaves(model)[0].shape[0]
    lo = local_rows(model.means)[0]
    local = jax.tree.map(lambda x: local_rows(x)[1], model)
    rec = ply_io.pack_records(checkpoint.gaussian_columns(local))
    header = ply_io.ply_header([n for n, _ in rec.dtype.fields.items()],
                               n_total)

    if jax.process_count() == 1:
        with open(path, "wb") as f:
            f.write(header)
            f.write(rec.tobytes())
        return

    from jax.experimental import multihost_utils
    if is_primary():
        with open(path, "wb") as f:
            f.write(header)
    multihost_utils.sync_global_devices("gsplat:export_ply_sharded:hdr")
    with open(path, "r+b") as f:
        f.seek(len(header) + lo * rec.itemsize)
        f.write(rec.tobytes())
    multihost_utils.sync_global_devices("gsplat:export_ply_sharded:done")
