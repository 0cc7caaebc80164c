"""Multi-host execution: `jax.distributed` wiring + global-array helpers.

The reference has NO distributed layer (SURVEY.md §2.3 — its only
inter-process communication is a multiprocessing.Queue to the Pangolin
viewer, viewer.py:11-16). This module is the north-star
"collective backend" row: processes join a cluster via
`jax.distributed.initialize`, a global Mesh spans every host's devices,
and the landmark-sharded BA (parallel/sharded_ba.py) runs unchanged on
top — `jax.lax.psum` compiles to the runtime's collectives within a host
and to cross-host transfers between processes.

Tested without multi-host hardware by spawning N CPU processes
(`XLA_FLAGS=--xla_force_host_platform_device_count=M`,
`jax_cpu_collectives_implementation=gloo`) — see
tests/test_multihost.py and scripts/multihost_ba_worker.py; the result is
asserted numerically identical to the single-process solver.
"""
from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_from_env() -> int:
    """Join the JAX distributed cluster from VSLAM_* environment variables.

    VSLAM_COORDINATOR (host:port), VSLAM_NUM_PROCESSES, VSLAM_PROCESS_ID.
    Under a CPU fleet the caller must also have set
    XLA_FLAGS=--xla_force_host_platform_device_count=M and
    JAX_PLATFORMS=cpu BEFORE importing jax. Returns the process id.
    No-op (returns 0) when the variables are absent (single-process run).
    """
    coord = os.environ.get("VSLAM_COORDINATOR")
    if not coord:
        return 0
    nproc = int(os.environ["VSLAM_NUM_PROCESSES"])
    pid = int(os.environ["VSLAM_PROCESS_ID"])
    # NOTE: must not touch the backend (jax.devices()/default_backend())
    # before distributed.initialize — decide from the environment instead.
    if "cpu" in os.environ.get("JAX_PLATFORMS", "").lower():
        # Cross-process CPU collectives need the gloo transport.
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    return pid


def global_mesh(axis: str = "pt") -> Mesh:
    """1-D mesh over EVERY device in the cluster (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def host_device_mesh(host_axis: str = "host", dev_axis: str = "dev") -> Mesh:
    """2-D (n_hosts, devices_per_host) mesh.

    Row h = the local devices of process h, so collectives along `dev_axis`
    stay on-host and only the `host_axis` reductions cross hosts.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_hosts = jax.process_count()
    per = len(devs) // n_hosts
    grid = np.array(devs).reshape(n_hosts, per)
    return Mesh(grid, (host_axis, dev_axis))


def make_global(x: np.ndarray, mesh: Mesh, spec: P) -> jax.Array:
    """Build a global sharded jax.Array from host-replicated NumPy data.

    Every process passes the SAME full array; each only materializes its
    addressable shards (the standard multi-host ingestion pattern when the
    problem fits in host RAM — the large-map path feeds per-host slices
    instead, see parallel/ba_large.py).
    """
    x = np.asarray(x)
    s = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, s, lambda idx: x[idx])


def make_global_problem(p, mesh: Mesh):
    """Shard a host-side BAProblem (NumPy/jnp leaves, replicated on every
    process) into global arrays over `mesh`'s single axis."""
    from . import sharded_ba

    (axis,) = mesh.axis_names
    specs = sharded_ba.problem_specs(axis)
    return jax.tree.map(
        lambda x, sp: make_global(np.asarray(x), mesh, sp), p, specs
    )


def gather_shards(x: jax.Array) -> list[tuple[tuple, np.ndarray]]:
    """This process's addressable (index, data) shards of a global array."""
    return [
        (tuple(s.index), np.asarray(s.data)) for s in x.addressable_shards
    ]


def spawn_worker_fleet(
    n_hosts: int,
    n_local_devices: int,
    worker_argv: list[str],
    coordinator_port: int | None = None,
    timeout_s: float = 420.0,
) -> list[str]:
    """Spawn `n_hosts` worker processes that join one jax.distributed
    cluster, wait for all, and return their combined stdout logs.

    Shared launch machinery for tests/test_multihost.py and
    __graft_entry__.dryrun_multihost. Picks a free coordinator port unless
    one is given (a stale process on a hard-coded port would deadlock every
    later fleet), and kills the whole fleet on any timeout/failure so no
    worker outlives a failed launch.

    Raises RuntimeError (with the worker log tail) on nonzero exit or
    timeout.
    """
    import socket
    import subprocess
    import sys

    if coordinator_port is None:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            coordinator_port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    env.update(
        VSLAM_COORDINATOR=f"localhost:{coordinator_port}",
        VSLAM_NUM_PROCESSES=str(n_hosts),
        VSLAM_LOCAL_DEVICES=str(n_local_devices),
    )
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    files = []
    try:
        import tempfile

        for pid in range(n_hosts):
            e = dict(env, VSLAM_PROCESS_ID=str(pid))
            # stdout to a temp FILE, not a PIPE: a worker blocked on a full
            # 64 KB pipe would stall the gloo collectives every other
            # worker is waiting in.
            f = tempfile.TemporaryFile()
            files.append(f)
            procs.append(
                subprocess.Popen(
                    [sys.executable] + worker_argv,
                    env=e,
                    stdout=f,
                    stderr=subprocess.STDOUT,
                    cwd=repo,
                )
            )
        for p in procs:
            try:
                p.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"multihost worker pid={p.pid} timed out after {timeout_s}s"
                )
        logs = []
        for f in files:
            f.seek(0)
            logs.append(f.read().decode())
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"multihost worker failed:\n{log[-2000:]}")
        return logs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in files:
            f.close()
