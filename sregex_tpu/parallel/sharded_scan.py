"""Multi-device data-parallel DFA scan.

The reference is single-threaded C; the distributed dimension here is
net-new architecture (SURVEY.md §5, §7): corpus shards are
data-parallel across a `jax.sharding.Mesh`, the compiled DFA tables
are replicated, and cross-shard correctness uses the same associative
transfer-function composition as the single-device chunk scan — each
shard reduces to an S-vector summary (phi, first-match), summaries are
all_gathered (S*8 bytes per device — negligible next to the
scan), and the final
fold runs everywhere redundantly.  The streaming-resume semantics of
sre_vm_pike_exec (SRE_AGAIN carry) thus become a scan carry whose
boundary-crossing state is exactly the DFA state id.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.scan import (chunk_transfer, compose, _NO_MATCH, _NO_MATCH_ABS)


def make_mesh(devices=None, axis="data"):
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


@functools.partial(jax.jit, static_argnames=("chunk_len", "mesh", "axis"))
def _sharded_scan(fused_bm, data, valid_len, *, chunk_len, mesh, axis):
    """data: uint8 [C, K] with C divisible by mesh size; returns the
    global (phi [S], fm [S], fid [S]) summary (replicated)."""

    def per_shard(fused_bm, data, valid_len):
        # local chunk transfer + local tree reduction
        phi, fm, fid = chunk_transfer(fused_bm, data, valid_len,
                                      chunk_len=chunk_len)
        # widen to int64 the moment offsets become absolute: the
        # aggregate corpus across shards crosses any int32 bound first
        base = jnp.cumsum(valid_len.astype(jnp.int64)) - valid_len
        fm = jnp.where(fm >= _NO_MATCH, _NO_MATCH_ABS,
                       fm.astype(jnp.int64) + base[:, None])
        n = phi.shape[0]
        while n > 1:
            half = n // 2
            new = compose(
                (phi[0:2 * half:2], fm[0:2 * half:2],
                 fid[0:2 * half:2]),
                (phi[1:2 * half:2], fm[1:2 * half:2],
                 fid[1:2 * half:2]))
            if n % 2:
                new = (jnp.concatenate([new[0], phi[-1:]], axis=0),
                       jnp.concatenate([new[1], fm[-1:]], axis=0),
                       jnp.concatenate([new[2], fid[-1:]], axis=0))
            phi, fm, fid = new
            n = phi.shape[0]
        # local summary -> global: gather all shard summaries (tiny)
        # and compose in shard order on every device
        local_bytes = jnp.sum(valid_len.astype(jnp.int64))
        phi_all = jax.lax.all_gather(phi[0], axis)      # [D, S]
        fm_all = jax.lax.all_gather(fm[0], axis)        # [D, S] int64
        fid_all = jax.lax.all_gather(fid[0], axis)      # [D, S]
        nb_all = jax.lax.all_gather(local_bytes, axis)  # [D]
        base_all = jnp.cumsum(nb_all) - nb_all
        fm_all = jnp.where(fm_all >= _NO_MATCH_ABS, _NO_MATCH_ABS,
                           fm_all + base_all[:, None])
        D = phi_all.shape[0]
        acc = (phi_all[0], fm_all[0], fid_all[0])
        for d in range(1, D):
            acc = compose(acc, (phi_all[d], fm_all[d], fid_all[d]))
        acc_phi, acc_fm, acc_fid = acc
        return acc_phi[None], acc_fm[None], acc_fid[None]

    f = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis, None), P(axis, None)),
        # the fori_loop carry starts replicated and becomes
        # shard-varying; skip the strict VMA check
        check_vma=False,
    )
    phi, fm, fid = f(fused_bm, data, valid_len)
    # every shard returns the same global summary; take shard 0's
    return phi[0], fm[0], fid[0]


def sharded_scan_bytes(tables, data_np, mesh=None, chunk_len=8192,
                       axis="data", entry_state=0):
    """Whole-corpus scan across the mesh.  Returns (final_state,
    first_match_end or -1, regex_id or -1): the earliest match end
    across all shards and WHICH pattern matched there (multi-pattern
    sets, sre_vm_pike.c:607-658; the id rides the transfer summaries
    through the all_gather composition).  EOF acceptance is the
    caller's: tables['match_eof_id'][final_state]."""
    if mesh is None:
        mesh = make_mesh()
    D = mesh.devices.size
    n = len(data_np)
    K = int(chunk_len)
    # pad so chunk count divides the mesh
    C = -(-max(n, 1) // K)
    C = -(-C // D) * D
    padded = np.zeros(C * K, dtype=np.uint8)
    padded[:n] = np.frombuffer(data_np, dtype=np.uint8)
    valid = np.zeros(C, dtype=np.int32)
    full = n // K
    valid[:full] = K
    if full < C and n - full * K > 0:
        valid[full] = n - full * K
    with mesh, jax.enable_x64():
        phi, fm, fid = _sharded_scan(tables["fused_bm"],
                                     jnp.asarray(padded.reshape(C, K)),
                                     jnp.asarray(valid),
                                     chunk_len=K, mesh=mesh, axis=axis)
    phi = np.asarray(phi)
    fm = np.asarray(fm)
    fid = np.asarray(fid)
    final_state = int(phi[entry_state])
    first = int(fm[entry_state])
    if first >= int(_NO_MATCH_ABS):
        return final_state, -1, -1
    return final_state, first, int(fid[entry_state])
