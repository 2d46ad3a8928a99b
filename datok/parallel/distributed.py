"""Multi-host corpus processing (one process per host, SPMD).

The reference scales across machines with external job schedulers over
files (SURVEY.md §2.3/§5 — no in-process distribution of any kind).
Here (per BASELINE.md):

  * every process (host) runs this same program SPMD
    (``jax.distributed.initialize``);
  * the corpus file list is sharded **deterministically by process
    index** — hosts never exchange input bytes, only counters, so
    cross-host traffic is a few dozen scalars per run;
  * within a host, lanes are data-parallel over the local devices
    (:class:`~datok.parallel.mesh.ShardedEngine`); the transition
    table is replicated everywhere;
  * global corpus counters are the only collective — an all-reduce
    that crosses hosts once at the end (or per reporting interval), so
    scaling efficiency is bounded by input IO, not communication.

Everything here degrades to a no-op in a single-process run, which is
how the unit tests exercise it (the driver's multi-chip dry run uses a
virtual device mesh; real multi-host init needs a coordinator).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

import jax


_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> bool:
    """Initialize ``jax.distributed`` for a multi-host run (idempotent).

    Arguments default to the standard environment variables
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``), which cluster launchers (GKE/SLURM/Borg-style)
    set per task; where the cluster runtime is one JAX can detect,
    ``jax.distributed.initialize()`` autodetects everything and the
    variables are unnecessary.  Returns True if distributed mode is
    active after the call.  A single-process run (no coordinator
    configured) is a silent no-op — the rest of this module then
    behaves as process 0 of 1.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None and env_np:
        num_processes = int(env_np)
    if process_id is None and env_pid:
        process_id = int(env_pid)
    if coordinator_address is None and num_processes is None:
        return jax.process_count() > 1  # single process: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    _initialized = True
    return jax.process_count() > 1


def process_shard(
    items: Sequence,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> list:
    """This process's deterministic shard of a corpus item list.

    Contiguous block assignment (not round-robin): corpus files are
    commonly sorted so that neighbours have similar sizes, and blocks
    keep each host's working set contiguous on shared filesystems.
    Every item is assigned to exactly one process; the union over all
    processes is the full list.
    """
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    n = len(items)
    lo = (n * pi) // pc
    hi = (n * (pi + 1)) // pc
    return list(items[lo:hi])


def global_mesh(local_axis: str = "data", host_axis: str = "host"):
    """A (host, data) mesh: hosts on the network, local devices on
    the host's own links.

    Shardings that use only ``local_axis`` keep collectives inside a
    host; reductions over both axes cross hosts exactly once (the counter
    all-reduce).  Single-host: the host axis has size 1, so the same
    program runs unchanged.
    """
    from jax.sharding import Mesh

    n_hosts = jax.process_count()
    local = jax.local_device_count()
    devs = np.asarray(jax.devices()).reshape(n_hosts, local)
    return Mesh(devs, (host_axis, local_axis))


def allreduce_counters(counters: dict) -> dict:
    """Sum integer counters across all processes (identity if single).

    The values must have the same keys in the same order on every
    process (SPMD discipline).  This is the one cross-host collective of a
    corpus run.
    """
    if jax.process_count() <= 1:
        return dict(counters)
    from jax.experimental import multihost_utils

    keys = sorted(counters)
    local = np.asarray([counters[k] for k in keys], dtype=np.int64)
    gathered = multihost_utils.process_allgather(local)
    summed = np.asarray(gathered).reshape(jax.process_count(), -1).sum(axis=0)
    return {k: int(v) for k, v in zip(keys, summed)}


def run_corpus_distributed(
    tok,
    files: Sequence[str],
    out_dir: str,
    flags: Optional[int] = None,
    engine=None,
    verbose: bool = False,
) -> dict:
    """Tokenize a corpus across all processes; return global counters.

    Each process handles its :func:`process_shard` of ``files`` with
    the resumable :class:`~datok.runtime.corpus.CorpusRunner`
    (per-process manifest, so any host can crash and resume
    independently), then the per-process counters are all-reduced.
    """
    from ..runtime.corpus import CorpusRunner
    from ..runtime.writer import SIMPLE

    mine = process_shard(files)
    manifest = f"manifest.p{jax.process_index()}.json"
    runner = CorpusRunner(
        tok,
        out_dir,
        flags=SIMPLE if flags is None else flags,
        engine=engine,
        manifest_name=manifest,
    )
    stats = runner.run(mine, verbose=verbose)
    local = {
        k: int(v)
        for k, v in stats.items()
        if isinstance(v, (int, np.integer))
    }
    out = allreduce_counters(local)
    out["processes"] = jax.process_count()
    return out
