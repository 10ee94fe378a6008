"""Multi-host bootstrap: jax.distributed initialization + the global
mesh and per-host corpus slicing used by the sharded scans.

The scan design needs nothing else for multi-host: tables are
replicated, corpus shards are data-parallel, and the only collective
is the tiny per-scan summary all_gather (S-vector or per-chunk
planes), which XLA routes over the interconnect automatically once
the mesh spans hosts (multi-host scaling is not measured yet; the
2-process CPU test validates the sharding program).

Usage on each host:

    from sregex_tpu.parallel import distributed as dist
    dist.initialize()                  # COORDINATOR_ADDRESS etc.
    mesh = dist.global_mesh()
    lo, hi = dist.host_slice(len(corpus))   # this host's byte range
    # feed corpus[lo:hi] through sharded/spec scans with mesh=mesh
"""

import os

import numpy as np
import jax


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, **kw):
    """jax.distributed.initialize with environment fallbacks
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); on GPU hosts
    give all three (nothing autodetects them).  Safe to call once
    per process before any device computation; a no-op when the
    backend is already initialized."""
    if jax.process_count() > 1:
        return  # already initialized by the runtime
    args = {}
    ca = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if ca:
        args["coordinator_address"] = ca
    np_ = num_processes or os.environ.get("NUM_PROCESSES")
    if np_:
        args["num_processes"] = int(np_)
    pid = process_id if process_id is not None \
        else os.environ.get("PROCESS_ID")
    if pid is not None:
        args["process_id"] = int(pid)
    args.update(kw)
    try:
        jax.distributed.initialize(**args)
    except (ValueError, RuntimeError):
        # single-process run (no coordinator reachable / already up):
        # the mesh below still covers all local devices
        pass


def global_mesh(axis="data", devices=None):
    """1-D mesh over every device in the (possibly multi-host) job,
    in process-major order so each host's corpus slice lands on its
    own devices."""
    from jax.sharding import Mesh
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def host_slice(nbytes, chunk=1):
    """This process's contiguous [lo, hi) byte range of a corpus that
    is split evenly (in ``chunk``-sized units) across hosts."""
    p = jax.process_index()
    np_ = jax.process_count()
    units = -(-nbytes // chunk)
    per = -(-units // np_)
    lo = min(p * per * chunk, nbytes)
    hi = min((p + 1) * per * chunk, nbytes)
    return lo, hi
