"""True multi-process (multi-host) sharded scan.

Each process holds only ITS slice of the corpus; the kernel runs ONCE
collectively over the global mesh, and the host validation fold runs
identically on every process from the replicated per-chunk planes,
handing the sequential carry across processes with one tiny allgather
per natively-repaired chunk (the owner of the chunk's raw bytes
repairs it and broadcasts the result).

This is the general multi-host protocol of the design (SURVEY.md §5
"distributed backend"): tables replicated, corpus shards data-
parallel, collectives limited to per-scan summaries.  The 2-host
scaling target (BASELINE.md) is structural — the only cross-host
traffic is O(C) bytes of planes + O(repairs) scalars.

Slice layout.  The kernel shards the BLOCK dim, and one block is
LANES (= 4096) chunks.  Two regimes:

- ALIGNED (``host_slices`` ranges): every process except the last is
  block-exact, so lane order == corpus-chunk order and the device
  summary's validated-prefix shortcut applies (zero plane readback on
  clean scans).
- RAGGED (arbitrary non-empty byte ranges): processes pad their
  prepped blocks to a common count; pad lanes interleave between
  processes, so the fold switches to a pad-aware lane map (corpus
  chunk -> lane) built from an allgathered (blocks, chunks, bytes)
  triple per process, ignores the device summary (its chain assumes
  lane order), and repairs each process's ragged LAST chunk natively
  via the owner-broadcast handoff.  Exactness is identical; the cost
  is the O(C) plane readback on every scan.  Real corpus splits
  (files of arbitrary size per host) need no re-chopping.

Tested end-to-end with two real jax.distributed processes on the
virtual CPU mesh (tests/multihost_runner.py; pytest wrapper
tests/test_multihost.py spawns the processes), including ragged
FIRST-process slices.
"""

from types import SimpleNamespace

import numpy as np

import jax

LANES = 4096          # chunks (stream lanes) per block: G * 8 * 128


def block_bytes(chunk_len):
    """Bytes covered by one kernel block."""
    return LANES * chunk_len


def host_slices(nbytes, nprocs, chunk_len, ndevices):
    """Aligned [lo, hi) corpus ranges per process (the FAST layout:
    lane order == chunk order, device-summary shortcut applies).

    Every process contributes the same number of blocks (sharding
    needs nprocs*bpp divisible by ndevices), and every process except
    the LAST is block-exact.  count_multihost/scan_multihost also
    accept ARBITRARY non-empty ranges (see module docstring) — use
    this helper when the caller controls the split, pass natural file
    boundaries when it doesn't."""
    bb = block_bytes(chunk_len)
    bpp = max(1, -(-nbytes // (bb * nprocs)))
    while (nprocs * bpp) % ndevices:
        bpp += 1
    per = bpp * bb
    assert nbytes > (nprocs - 1) * per + (bpp - 1) * bb, \
        "corpus too small for %d procs x %d blocks of %d bytes" \
        % (nprocs, bpp, bb)
    out = []
    for p in range(nprocs):
        lo = p * per
        hi = (p + 1) * per if p < nprocs - 1 else nbytes
        out.append((lo, hi))
    return out


def _replicated(mesh, arr):
    from jax.sharding import NamedSharding, PartitionSpec as P
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P()), np.asarray(arr))


def _launch(tables, local_bytes, mesh, chunk_len, full_len,
            entry_state, axis, COUNT):
    """Shared prep + collective kernel launch.  Returns a namespace
    with the replicated summary, the unpacked per-chunk planes in
    CORPUS order (ragged mode only; None in aligned mode unless the
    caller pulls them), and the fold geometry."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.experimental import multihost_utils as mhu
    from ..ops.prep import prepare_auto
    from ..ops.pallas_scan import effective_chunk
    import jax.numpy as jnp

    assert not type(tables).__name__.endswith("Pair"), \
        "byte-alphabet tiers only (pair premultiplies by ncls^2)"
    pid = jax.process_index()
    nproc = jax.process_count()
    K = effective_chunk(tables, chunk_len)
    assert K == chunk_len, \
        "chunk_len %d is not prep-exact for these tables (use %d; " \
        "slices must be computed with the same value)" \
        % (chunk_len, K)
    ncls = tables.ncls
    W = tables.warmup
    n = full_len
    bb = block_bytes(K)
    n_loc = len(local_bytes)
    assert n_loc > 0, "every process must hold a non-empty slice"

    prepared = prepare_auto(tables, local_bytes, K)
    data, C_loc, _K, J, B_loc = prepared
    meta = mhu.process_allgather(
        np.array([B_loc, C_loc, n_loc], np.int64))
    Bs = meta[:, 0].astype(np.int64)
    Cs = meta[:, 1].astype(np.int64)
    Ns = meta[:, 2].astype(np.int64)
    assert int(Ns.sum()) == n, \
        "slices cover %d bytes, corpus is %d" % (int(Ns.sum()), n)
    ndev = mesh.devices.size

    uniform = (int(Bs.min()) == int(Bs.max())
               and int(Bs.sum()) % ndev == 0
               and all(int(Ns[p]) % bb == 0 for p in range(nproc - 1)))
    if uniform:
        B_glob = int(Bs.sum())
        C_kernel = -(-n // K)              # global real chunks
        bad_tail = (C_kernel - 1) \
            if C_kernel * K > n and (n - (C_kernel - 1) * K) != K \
            else -1
    else:
        # RAGGED: pad every process to a common block count that
        # shards evenly; pad lanes scan zero classes and the fold
        # ignores them via the lane map
        B_tgt = int(Bs.max())
        ndev_loc = max(1, ndev // nproc)
        while B_tgt % ndev_loc or (nproc * B_tgt) % ndev:
            B_tgt += 1
        if B_loc < B_tgt:
            d = np.asarray(data)
            pad = np.zeros((B_tgt - B_loc,) + d.shape[1:], d.dtype)
            data = np.concatenate([d, pad], axis=0)
            B_loc = B_tgt
        B_glob = nproc * B_tgt
        # the device summary's chain assumes lane==chunk order, which
        # pad interleaving breaks — mark every lane "real" and let the
        # pad-aware host fold decide; the summary is discarded
        C_kernel = B_glob * LANES
        bad_tail = -1

    sh = NamedSharding(mesh, P(axis))
    gdata = jax.make_array_from_process_local_data(
        sh, np.asarray(data))
    G = data.shape[2] if data.ndim == 5 else 4
    s0 = np.zeros((B_loc, G, 8, 128), np.int32)
    j0 = np.zeros((B_loc, G, 8, 128), np.int32)
    topm0 = getattr(tables, "to_premult", None)
    if pid == 0:
        s0[0, 0, 0, 0] = topm0(entry_state) if topm0 \
            else entry_state * ncls
        j0[0, 0, 0, 0] = W
    gs0 = jax.make_array_from_process_local_data(sh, s0)
    gj0 = jax.make_array_from_process_local_data(sh, j0)

    # replicate the table as a proper global array
    orig = tables.table
    tables.table = _replicated(mesh, orig)
    try:
        summary, packed = tables._scan(
            gdata, gs0, gj0, jnp.int32(C_kernel),
            jnp.int32(bad_tail), J, W, COUNT=COUNT, mesh=mesh,
            axis=axis)
    finally:
        tables.table = orig

    rep = jax.jit(lambda x: x,
                  out_shardings=NamedSharding(mesh, P()))
    summ = np.asarray(rep(summary)).astype(np.int64)

    raw = np.frombuffer(local_bytes, dtype=np.uint8) \
        if not isinstance(local_bytes, np.ndarray) else local_bytes
    first_chunk = np.concatenate(
        ([0], np.cumsum(Cs)))                   # global chunk base / p
    slice_off = np.concatenate(([0], np.cumsum(Ns)))
    return SimpleNamespace(
        pid=pid, nproc=nproc, K=K, ncls=ncls, n=n,
        uniform=uniform, summ=summ, packed=packed, rep=rep,
        C=(C_kernel if uniform else int(Cs.sum())),
        C_lanes=B_glob * LANES, bad_tail=bad_tail,
        Bs=Bs, Cs=Cs, Ns=Ns, B_loc=B_loc, raw=raw,
        first_chunk=first_chunk, slice_off=slice_off, mhu=mhu)


def _lane_planes(mh):
    """Unpack the replicated per-chunk planes and reindex them into
    CORPUS-chunk order (pad-aware: process p's real chunks live at
    lanes [p*B_tgt*LANES, p*B_tgt*LANES + Cs[p]))."""
    from ..ops.pallas_scan import _unpack
    a, b, c = _unpack(np.asarray(mh.rep(mh.packed)), mh.C_lanes)
    per = mh.C_lanes // mh.nproc
    lanes = np.concatenate(
        [p * per + np.arange(int(mh.Cs[p])) for p in range(mh.nproc)])
    return a[lanes], b[lanes], c[lanes]


def _full_vec(mh):
    """full[c]: corpus chunk c covers exactly K real bytes (each
    process's last chunk is ragged iff its slice isn't K-exact)."""
    full = np.ones(mh.C, dtype=bool)
    for p in range(mh.nproc):
        if int(mh.Ns[p]) % mh.K:
            full[int(mh.first_chunk[p] + mh.Cs[p]) - 1] = False
    return full


def _owner_of(mh, c):
    p = int(np.searchsorted(mh.first_chunk, c, side="right")) - 1
    lc = c - int(mh.first_chunk[p])
    lo = lc * mh.K
    hi = min(lo + mh.K, int(mh.Ns[p]))
    return p, lo, hi


def count_multihost(tables, local_bytes, mesh, chunk_len,
                    full_len, entry_state=0, axis="data"):
    """Count match-ending boundaries (0..full_len-1) of the global
    corpus, of which this process holds ``local_bytes`` (an aligned
    host_slices range, or ANY non-empty byte range — see module
    docstring).  Returns (final_state, count), identical on every
    process.  EOF boundary is the caller's (tables.match_eof)."""
    from ..native import NativeDfa
    from ..ops.pallas_scan import _unpack

    mh = _launch(tables, local_bytes, mesh, chunk_len, full_len,
                 entry_state, axis, COUNT=True)
    K, ncls, C = mh.K, mh.ncls, mh.C
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)
    native = NativeDfa(tables.dfa)

    if mh.uniform:
        summ = mh.summ
        if bool(summ[0]) and mh.n < 2 ** 31:
            return frpm(int(summ[6])), int(summ[7])
        phi, cnt, swarm = _unpack(np.asarray(mh.rep(mh.packed)), C)
        full = np.ones(C, dtype=bool)
        if mh.bad_tail >= 0:
            full[mh.bad_tail] = False
        if bool(summ[0]):
            # count overflowed int32 summary: re-sum on host
            return frpm(int(summ[6])), \
                int(np.sum(cnt, dtype=np.int64))
        e = int(summ[2])
        c = int(summ[1])
        total = int(summ[7])
    else:
        phi, cnt, swarm = _lane_planes(mh)
        full = _full_vec(mh)
        e = topm(entry_state)
        c = 0
        total = 0

    cont = np.zeros(C, dtype=bool)
    if C > 1:
        cont[:C - 1] = full[1:] & (swarm[1:] == phi[:C - 1])
    breaks = np.flatnonzero(~cont)
    cum = np.cumsum(cnt.astype(np.int64))

    # replicated fold; the owner of a chunk's bytes repairs it and
    # broadcasts (count, exit state) — every process walks the same
    # control flow, so the collectives stay in lockstep
    while c < C:
        if full[c] and int(swarm[c]) == e:
            b = int(breaks[np.searchsorted(breaks, c)])
            total += int(cum[b] - (cum[c - 1] if c else 0))
            e = int(phi[b])
            c = b + 1
            continue
        owner, lo, hi = _owner_of(mh, c)
        if mh.pid == owner:
            k, st = native.count(mh.raw[lo:hi].tobytes(), frpm(e))
            mine = np.array([k, topm(st)], np.int64)
        else:
            mine = np.zeros(2, np.int64)
        got = mh.mhu.process_allgather(mine)
        k, e = int(got[owner][0]), int(got[owner][1])
        total += k
        c += 1
    return frpm(e), total


def scan_multihost(tables, local_bytes, mesh, chunk_len,
                   full_len, entry_state=0, axis="data"):
    """Earliest match end over the global corpus: returns
    (final_or_boundary_state, end, regex_id), identical on every
    process.  end == -1 means no interior match (the EOF boundary is
    the caller's: tables.match_eof / dfa.match_eof_id of the final
    state).  On a match the state is the state AT the boundary and
    regex_id is resolved by the byte's owner (dfa.id_at needs
    data[end], which only one process holds).  ``local_bytes`` may be
    an aligned host_slices range or ANY non-empty byte range."""
    from ..native import NativeDfa
    from ..ops.pallas_scan import _unpack

    mh = _launch(tables, local_bytes, mesh, chunk_len, full_len,
                 entry_state, axis, COUNT=False)
    K, ncls, C = mh.K, mh.ncls, mh.C
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)
    native = NativeDfa(tables.dfa)

    if mh.uniform:
        summ = mh.summ
        if bool(summ[0]):
            # every chunk validated fire-free: no interior match
            return frpm(int(summ[6])), -1, -1
        phi, fm, swarm = _unpack(np.asarray(mh.rep(mh.packed)), C)
        full = np.ones(C, dtype=bool)
        if mh.bad_tail >= 0:
            full[mh.bad_tail] = False
        e = int(summ[2])
        c = int(summ[1])
    else:
        phi, fm, swarm = _lane_planes(mh)
        full = _full_vec(mh)
        e = topm(entry_state)
        c = 0

    quiet = full & (fm == 0)
    cont = np.zeros(C, dtype=bool)
    if C > 1:
        cont[:C - 1] = quiet[1:] & (swarm[1:] == phi[:C - 1])
    breaks = np.flatnonzero(~cont)

    def abs_off(cc):
        """Global byte offset of corpus chunk cc's first byte."""
        if mh.uniform:
            return cc * K
        p = int(np.searchsorted(mh.first_chunk, cc,
                                side="right")) - 1
        return int(mh.slice_off[p]) + (cc - int(mh.first_chunk[p])) * K

    def owner_scan(cc, ee):
        """Owner re-scans chunk cc from premult entry ee; broadcasts
        (first fire rel or -1, exit premult, regex id or -1)."""
        owner, lo, hi = _owner_of(mh, cc)
        if mh.pid == owner:
            f, st = native.scan_first(mh.raw[lo:hi].tobytes(),
                                      frpm(ee))
            rid = tables.dfa.id_at(st, mh.raw[lo + f]) if f >= 0 \
                else -1
            mine = np.array([f, topm(st), rid], np.int64)
        else:
            mine = np.zeros(3, np.int64)
        got = mh.mhu.process_allgather(mine)
        row = got[owner]
        return int(row[0]), int(row[1]), int(row[2])

    while c < C:
        if quiet[c] and int(swarm[c]) == e:
            b = int(breaks[np.searchsorted(breaks, c)])
            e = int(phi[b])
            c = b + 1
            continue
        f, st, rid = owner_scan(c, e)
        if f >= 0:
            return frpm(st), abs_off(c) + f, rid
        e = st
        c += 1
    return frpm(e), -1, -1
