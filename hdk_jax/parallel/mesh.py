"""Device mesh utilities.

The reference's parallelism axes are fragments x CPU threads and
fragments x GPUs (SURVEY.md §2.7).  Here one flat mesh axis ("frag")
shards table rows across devices; XLA hands the collectives to the
device's own library (NCCL over NVLink on GPUs).  There is no
hand-written transport (reference has none either —
SURVEY.md §2.8): XLA inserts the collectives from shard_map.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FRAG_AXIS = "frag"

_distributed_initialized = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None) -> None:
    """Join a multi-host job before building meshes.

    Thin, idempotent wrapper over ``jax.distributed.initialize``.  On
    GPU hosts nothing is detected: pass coordinator/count/id
    explicitly, or run under a launcher that sets JAX's cluster
    environment.  After this, ``jax.devices()`` spans all hosts and
    ``make_mesh`` builds a global mesh.  The reference is single-node
    (SURVEY.md §2.8) — this is capability the JAX design adds.
    """
    global _distributed_initialized
    if _distributed_initialized:
        return
    # NOTE: must not touch jax.devices()/process_count() here — any
    # backend-initialising call before jax.distributed.initialize is an
    # error; the distributed client handle is the safe probe
    from jax._src import distributed as _jdist

    if getattr(_jdist.global_state, "client", None) is not None:
        _distributed_initialized = True
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _distributed_initialized = True


def make_mesh(n_devices: Optional[int] = None, axis: str = FRAG_AXIS) -> Mesh:
    """Flat mesh over the first ``n_devices`` devices (all by default),
    global across hosts after ``init_distributed``.  Devices sort by id
    so every process builds the identical mesh, a requirement for
    multi-controller jit.  Too few visible devices is an error."""
    devs = sorted(jax.devices(), key=lambda d: d.id)
    if n_devices is not None and len(devs) < n_devices:
        raise RuntimeError(
            f"make_mesh({n_devices}): only {len(devs)} "
            f"{devs[0].platform} device(s) are visible")
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def row_sharding(mesh: Mesh, axis: str = FRAG_AXIS) -> NamedSharding:
    """Shard the row axis of a column across the mesh (fragment-data-
    parallelism, SURVEY.md P1)."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def process_row_quota(local_rows: int, mesh: Mesh) -> Tuple[int, int]:
    """(per_process_rows, global_rows) for process-local ingest: every
    process pads its local rows to a common quota divisible by its
    device share, so the global row-sharded array is uniform.  Runs one
    tiny allgather of the local counts."""
    nproc = jax.process_count()
    if nproc == 1:
        per = local_rows
        return per, per
    from jax.experimental import multihost_utils as mh

    counts = np.asarray(mh.process_allgather(
        np.asarray([local_rows], np.int64))).reshape(-1)
    dev_share = mesh.devices.size // nproc
    per = int(-(-int(counts.max()) // max(dev_share, 1)) * max(dev_share, 1))
    return per, per * nproc


def global_from_process_local(mesh: Mesh, local: np.ndarray, per: int,
                              global_rows: int, fill=0):
    """Build a global row-sharded array from THIS process's rows padded
    to the common quota (SPMD multi-host ingest: each host feeds its shard —
    SURVEY.md §2.8 'host-side Arrow ingest feeds per-host shards')."""
    pad = per - local.shape[0]
    if pad:
        local = np.concatenate(
            [local, np.full((pad,) + local.shape[1:], fill, local.dtype)])
    if jax.process_count() == 1:
        return jax.device_put(local, row_sharding(mesh))
    return jax.make_array_from_process_local_data(
        row_sharding(mesh), local, (global_rows,) + local.shape[1:])


def pad_to_multiple(arr, n: int, fill):
    """Pad the row axis so it divides evenly across n shards."""
    import jax.numpy as jnp

    rows = arr.shape[0]
    rem = rows % n
    if rem == 0:
        return arr, rows
    pad = n - rem
    fill_arr = jnp.full((pad,) + arr.shape[1:], fill, arr.dtype)
    return jnp.concatenate([arr, fill_arr]), rows


def allgather_host_strings(strings) -> list:
    """Gather every process's string list (rank order).  Strings ship as
    one NUL-separated utf-8 blob padded to the global max (two tiny
    collectives: sizes, then blobs)."""
    import jax

    if jax.process_count() == 1:
        return [list(strings)]
    from jax.experimental import multihost_utils as mh

    blob = np.frombuffer("\x00".join(strings).encode("utf-8"), np.uint8)
    sizes = np.asarray(mh.process_allgather(
        np.asarray([blob.size], np.int64))).reshape(-1)
    mx = max(int(sizes.max()), 1)
    padded = np.zeros((mx,), np.uint8)
    padded[:blob.size] = blob
    blobs = np.asarray(mh.process_allgather(padded))
    out = []
    for r in range(blobs.shape[0]):
        b = bytes(blobs[r][:int(sizes[r])])
        out.append(b.decode("utf-8").split("\x00") if b else [])
    return out


def unify_process_dictionary(dct) -> "np.ndarray":
    """Multi-controller dictionary unification (reference:
    StringDictionaryTranslationMgr + dictionary generations,
    Execute.h:305-315): every process contributes its process-local
    dictionary; all adopt the rank-ordered union as the canonical code
    space.  Returns the translation array old_local_code -> global_code
    for rewriting already-encoded columns.

    Must be called SPMD-synchronously by every process (the ingest path
    is identical on all controllers, so ordering holds by construction).
    """
    local = dct.all_strings()
    per_proc = allgather_host_strings(local)
    canonical: list = []
    seen: dict = {}
    for proc_strings in per_proc:
        for s in proc_strings:
            if s not in seen:
                seen[s] = len(canonical)
                canonical.append(s)
    dct.replace_contents(canonical)
    return np.asarray([seen[s] for s in local], np.int32)
