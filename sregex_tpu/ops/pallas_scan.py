"""Speculative chunk scan — the single-device fast path.

Design (data-parallel FSM with prefix speculation):

  - the input is class-mapped (byte -> equivalence class, dfa.py),
    cut into C chunks of K bytes, each chunk's window prefixed with W
    warmup bytes from the preceding chunk, and packed 8 (4-bit) or 4
    (8-bit) classes per int32 word;
  - the DFA is flattened into one table
    table[s*ncls + cls] = (next*ncls) | (match << 20), and every chunk
    is walked through it as an independent stream
    (ops/scan_kernel.py: one gather per byte, on the GPU a Pallas
    kernel that keeps each stream's state in registers);
  - match *positions* are not tracked in the hot loop: an
    OR-accumulator records whether any boundary in the chunk matched,
    and the host fold resolves exact offsets by re-scanning the first
    firing chunk with the native C++ engine (sregex_tpu/native.py);
  - chunks other than the first start their warmup from an arbitrary
    state; DFA convergence makes the state at the end of the warmup
    almost always equal the true entry state.  The walk records the
    speculative entry (``swarm``) and the fold validates it
    against the sequentially-known true entry, re-scanning mismatched
    chunks natively.  Exactness is therefore unconditional.

The tiers differ only in table size and packing: narrow (S*ncls <=
128, repair planes packed to uint8), wide (<= 4096 entries) and big
(ops/pallas_big.py, <= 2^17) share one walk over a flat table.

This replaces the reference's DynASM x86-64 JIT as the "compiled" hot
path (sre_vm_thompson_x64.dasc); the per-byte work is one table load
versus the JIT's per-thread native dispatch loop.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

from .scan_kernel import (MATCH_SHIFT as _MATCH_SHIFT,
                          STATE_MASK as _STATE_MASK, implementation,
                          table_size, walk)

WORDS_PER_ITER = 2   # chunk bodies are a multiple of this many words
# Layout groups: a prep block holds GROUPS * TILE chunk streams
# ([B, Jw, GROUPS, 8, 128]); the walk treats them all alike.
# SREGEX_GROUPS overrides (the CPU test suite pins 4).
GROUPS = int(os.environ.get("SREGEX_GROUPS", "8"))
TILE = 1024          # streams per group (8 x 128)
DEFAULT_K = 2048     # nominal chunk length (rounded to the packing)


def max_chunk_bytes(cpw, bpu=1):
    """Chunk clamp: the largest K (bytes) on the packing quantum whose
    per-chunk match counts fit the 16 bits the repair planes carry
    (the walk itself has no chunk-length bound)."""
    quantum = cpw * WORDS_PER_ITER * bpu
    return ((1 << 16) - 1) // quantum * quantum


def flat_table(trans, match, ncls):
    """Device table of a transition function: entry s*ncls + c =
    (trans[s, c] * ncls) | (match[s, c] << 20), zero-padded to
    scan_kernel.table_size.  ``trans``/``match`` [S, ncls] (a pair
    tier passes its composed table and count)."""
    trans = np.asarray(trans, dtype=np.int64)
    match = np.asarray(match, dtype=np.int64)
    flat = np.zeros(table_size(trans.size), dtype=np.int32)
    flat[:trans.size] = ((trans * ncls) | (match << _MATCH_SHIFT)) \
        .reshape(-1).astype(np.int32)
    return jnp.asarray(flat)


class _FlatTables:
    """Shared driver hook of the flat-table tiers: ``_scan`` runs the
    walk and the on-device validation summary (_spec_scan)."""

    last_repair = None   # see SpecTables.last_repair
    bpu = 1              # bytes per kernel unit (the pair tier: 2)

    def _scan(self, data, state0, j0, C, bad_tail, J, W, COUNT=False,
              mesh=None, axis=None, esc=None):
        # J, W, j0 arrive in bytes; the walk steps in kernel units
        u = self.bpu
        return _spec_scan(data, state0, j0 // u if u > 1 else j0,
                          self.table, C, bad_tail, W=W // u,
                          CPW=self.cpw, BITS=self.bits, COUNT=COUNT,
                          PACK8=self.nstates * self.ncls <= 128,
                          mesh=mesh, axis=axis, ESC=esc,
                          IMPL=implementation())


class SpecTables(_FlatTables):
    """Host-side preprocessing of a Dfa for the speculative scan
    (narrow tier: S * ncls <= 128)."""

    # repair stats of the last completed no-match scan: (natively
    # repaired chunks, total chunks); None after a matched/early-exit
    # scan.  Feeds Scanner.stats().
    last_repair = None

    def __init__(self, dfa):
        S, ncls = dfa.nstates, dfa.nclasses
        if S * ncls > 128:
            raise ValueError("automaton too large for the narrow "
                             "table (S*ncls = %d)" % (S * ncls))
        self.dfa = dfa
        self.nstates = S
        self.ncls = ncls
        # packing density: 4-bit classes (8 per word) by default;
        # 3-bit (10 per word) is opt-in via SREGEX_PACK_BITS=3.
        # Wide alphabets (16 < ncls <= 128, e.g. many-literal
        # multi-regex hot cores) pack 8-bit: half the per-word density.
        want = int(os.environ.get("SREGEX_PACK_BITS", "4"))
        if ncls > 16:
            self.bits = 8
            self.cpw = 4
        else:
            self.bits = 3 if (want == 3 and ncls <= 8) else 4
            self.cpw = 10 if self.bits == 3 else 8
        self.warmup = 4 * self.cpw
        self.max_chunk = max_chunk_bytes(self.cpw)
        self.table = flat_table(dfa.trans, dfa.match, ncls)
        self.class_map = dfa.class_map.astype(np.uint8)
        self.match_eof = dfa.match_eof


class SpecTablesWide(_FlatTables):
    """Like SpecTables for automata with 128 < S*ncls <= MAX_ENTRIES.
    The walk is the same; the tier keeps its own name because the
    Scanner's core-vs-static decision bands key on its row count
    (``rows`` = 128-entry rows of the table)."""

    MAX_ENTRIES = 4096

    last_repair = None   # see SpecTables.last_repair

    def __init__(self, dfa):
        S, ncls = dfa.nstates, dfa.nclasses
        if ncls > 256:
            raise ValueError("more than 256 byte classes (%d)" % ncls)
        if S * ncls > self.MAX_ENTRIES:
            raise ValueError("automaton too large for the wide fused "
                             "table (S*ncls = %d)" % (S * ncls))
        self.dfa = dfa
        self.nstates = S
        self.ncls = ncls
        # wide alphabets (many-literal multi-regex sets: ncls > 16)
        # pack 8-bit: the per-word density halves
        self.bits = 4 if ncls <= 16 else 8
        self.cpw = 8 if self.bits == 4 else 4
        self.warmup = 4 * self.cpw
        self.rows = -(-(S * ncls) // 128)
        self.max_chunk = max_chunk_bytes(self.cpw)
        self.table = flat_table(dfa.trans, dfa.match, ncls)
        self.class_map = dfa.class_map.astype(np.uint8)
        self.match_eof = dfa.match_eof


def _summarize(phi, fm, swarm, state0, C, bad_tail, COUNT, ESC=None):
    """Shared post-walk summary (see _spec_scan docstring).

    ESC (hot-core tier, ops/pallas_core.py): premultiplied id of the
    sticky escape state.  A chunk whose exit state is ESC left the
    core at some byte — its fm accumulator and exit are garbage past
    that byte, so the chunk must fail validation (the host repairs it
    with the FULL machine).  ESC is sticky, so phi == ESC iff the
    chunk ever escaped."""
    Cp = phi.size
    phi_f = phi.reshape(Cp)
    fm_f = fm.reshape(Cp)
    swarm_f = swarm.reshape(Cp)
    e0 = state0.reshape(Cp)[0]
    entries = jnp.concatenate([e0[None], phi_f[:-1]])
    idx = jnp.arange(Cp, dtype=jnp.int32)
    okv = swarm_f == entries
    if ESC is not None:
        okv = okv & (phi_f != ESC)
    if not COUNT:
        okv = okv & (fm_f == 0)
    okv = (okv | (idx >= C)) & (idx != bad_tail)
    all_ok = jnp.all(okv)
    fb = jnp.argmin(okv.astype(jnp.int32)).astype(jnp.int32)
    fb_eff = jnp.where(all_ok, C, fb)
    prefix_cnt = jnp.sum(jnp.where((idx < fb_eff) & (idx < C), fm_f, 0))
    fire = (fm_f != 0) & (idx < fb_eff) & (idx < C)
    last_fire = jnp.max(jnp.where(fire, idx, -1)).astype(jnp.int32)
    lf = jnp.maximum(last_fire, 0)
    summary = jnp.stack([
        all_ok.astype(jnp.int32), fb, entries[fb], phi_f[fb],
        swarm_f[fb], fm_f[fb], phi_f[C - 1],
        prefix_cnt.astype(jnp.int32), last_fire, entries[lf]])
    packed = jnp.stack([phi.astype(jnp.uint8),
                        (fm & 0xFF).astype(jnp.uint8),
                        swarm.astype(jnp.uint8),
                        ((fm >> 8) & 0xFF).astype(jnp.uint8)])
    return summary, packed


def _dispatch(data, state0, j0, table, *, W, CPW, BITS, COUNT, mesh,
              axis, IMPL):
    """Run the walk on one device or shard_mapped over a mesh.

    mesh=None: one walk over the whole batch.  With a mesh the
    batch (chunk-block) dim is data-parallel across devices: each
    device walks its contiguous block range with the SAME speculative
    walk (table replicated via P()), and the cross-device stitch is the
    existing swarm==entries validation chain — the per-chunk planes
    come back in global chunk order, so _summarize needs no
    mesh-awareness at all.  (The enumerative sharded_scan.py
    remains as the any-size fallback.)"""
    def run(d, s0, j0_, t):
        return walk(d, s0, j0_, t, W=W, CPW=CPW, BITS=BITS,
                    COUNT=COUNT, impl=IMPL)

    if mesh is None:
        return run(data, state0, j0, table)
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    return shard_map(
        run, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )(data, state0, j0, table)


@functools.partial(jax.jit,
                   static_argnames=("W", "CPW", "BITS", "COUNT", "PACK8",
                                    "mesh", "axis", "ESC", "IMPL"))
def _spec_scan(data, state0, j0, table, C, bad_tail, *, W, CPW, BITS,
               COUNT=False, PACK8=True, mesh=None, axis=None, ESC=None,
               IMPL="plain"):
    """data: int32 [B, Jw, G, 8, 128] packed; state0/j0:
    [B, G, 8, 128]; W in kernel units; C = live chunk count (traced
    scalar); bad_tail = index of a ragged tail chunk or -1.

    Returns (summary int32 [10], packed repair planes).
    The summary performs the speculation-chain validation ON DEVICE so
    the common case reads back ~40 bytes instead of megabytes:
      [0] all_ok  [1] first_bad  [2] entry@first_bad  [3] phi@first_bad
      [4] swarm@first_bad  [5] fm@first_bad  [6] phi@C-1
      [7] sum(fm[0:first_bad])  (the valid-prefix count, COUNT mode)
      [8] last firing chunk in the validated prefix (-1 none)
      [9] entry @ that chunk
    The packed array is the full per-chunk data for the (rare) repair
    path: PACK8 (premultiplied states < 256) packs uint8 [4, ...]
    planes (phi, fm-lo, swarm, fm-hi); larger tables keep int32
    [3, ...] planes (phi, fm, swarm) — _unpack() dispatches on the
    plane count."""
    phi, fm, swarm = _dispatch(data, state0, j0, table, W=W, CPW=CPW,
                               BITS=BITS, COUNT=COUNT, mesh=mesh,
                               axis=axis, IMPL=IMPL)
    summary, packed8 = _summarize(phi, fm, swarm, state0, C, bad_tail,
                                  COUNT, ESC=ESC)
    if PACK8:
        return summary, packed8
    return summary, jnp.stack([phi, fm, swarm])


def _unpack(outs, C):
    """Host-side unpack of the repair-path arrays for either packed
    format (narrow uint8 [4,...] with lo/hi count planes, or wide
    int32 [3,...])."""
    outs = np.asarray(outs).astype(np.int64)
    total = outs.shape[1] * outs.shape[2] * outs.shape[3] * outs.shape[4]
    phi = outs[0].reshape(total)[:C]
    swarm = outs[2].reshape(total)[:C]
    if outs.shape[0] == 4:
        fmcnt = (outs[1] | (outs[3] << 8)).reshape(total)[:C]
    else:
        fmcnt = outs[1].reshape(total)[:C]
    return phi, fmcnt, swarm


def with_warmup(tables, W):
    """Tables variant with a LONGER speculation warmup window.

    Bounded-history automata (counted repetitions a{n,m}...: the run
    counter saturates at the max bound) converge through a warmup of
    W >= their history bound on ANY corpus — so a corpus whose run
    lengths defeat the default 32-byte window (measured: 74% of
    chunks repaired natively on a{60,120}b over long-run data) scans
    clean once W exceeds the bound (1 ragged-tail repair).  The copy
    shares every fused table; only the window length (and therefore
    the prep layout and the kernel trace) changes.  Returns None when
    the tables can't host the window: byte-unit tiers only (the pair
    tier's tiny machines are never history-bounded past 32)."""
    import copy
    if getattr(tables, "bpu", 1) != 1 or tables.bits not in (4, 8):
        return None
    if W % tables.cpw or not (tables.warmup < W <= 2048):
        return None
    t = copy.copy(tables)
    t.warmup = int(W)
    if effective_chunk(t, DEFAULT_K) < t.warmup // 2:
        return None     # the window would dwarf the chunk: no gain
    t.last_repair = None
    return t


def effective_chunk(tables, chunk_len):
    """The chunk length the prep actually uses: rounded down to the
    packing quantum and clamped to the tables' max_chunk
    (max_chunk_bytes).  Exposed so chunk-indexed consumers (the finditer
    start locator) agree with the prep about K."""
    CPW = tables.cpw
    bpu = getattr(tables, "bpu", 1)    # bytes per kernel unit
    quantum = CPW * WORDS_PER_ITER * bpu
    chunk_len = min(int(chunk_len),
                    getattr(tables, "max_chunk", 1 << 15))
    K = max(quantum, chunk_len // quantum * quantum)
    if K >= 1 << 16:
        # per-chunk match counts ride 16 bits in the packed planes
        raise ValueError("chunk_len must be < 65536 (got %d)" % K)
    return K


def _prepare(tables, data_np, chunk_len, b_multiple=1,
             prev_tail_cls=None, block=True):
    """Host prep: class-map, overlapping windows, 4-per-word packing,
    tiling into [B, J//4, G, 8, 128].  Vectorized.  b_multiple pads
    the block count so it shards evenly over a mesh.

    prev_tail_cls: optional uint8 [W] of CLASS ids filling chunk 0's
    warmup window (the last W stream bytes before this segment,
    class-mapped) — the pipelined streaming scan (ops/pipeline.py)
    uses it so a non-first segment's chunk 0 speculates over REAL
    bytes instead of the zero-class pad.  block=False skips the
    block_until_ready (the pipeline overlaps uploads with scans)."""
    from numpy.lib.stride_tricks import sliding_window_view

    n = len(data_np)
    CPW = tables.cpw
    bpu = getattr(tables, "bpu", 1)    # bytes per kernel unit
    K = effective_chunk(tables, chunk_len)
    W = tables.warmup
    G = GROUPS
    C = max(1, -(-n // K))
    B = -(-C // (G * TILE))
    B = -(-B // b_multiple) * b_multiple
    Cp = B * G * TILE
    J = W + K

    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np

    if bpu == 2:
        return _prepare_pair(tables, raw, n, K, W, G, C, B, Cp, J,
                             prev_tail_cls=prev_tail_cls, block=block)

    from ..native import get_lib, _u8p, _i32p
    lib = get_lib()
    if tables.bits == 4 and prev_tail_cls is None and lib is not None \
            and hasattr(lib, "sre_pack_prepare"):
        # native single-pass prepare (numpy's strided paths are
        # pathologically slow on large arrays in some environments)
        packed = np.empty((B, J // CPW, GROUPS, 8, 128),
                          dtype=np.int32)
        lib.sre_pack_prepare(_u8p(raw), n, _u8p(tables.class_map),
                             K, W, GROUPS, Cp,
                             _i32p(packed.reshape(-1)))
    else:
        cls = np.frombuffer(
            raw.tobytes().translate(tables.class_map.tobytes()),
            dtype=np.uint8)
        padded = np.zeros(W + Cp * K, dtype=np.uint8)
        if prev_tail_cls is not None:
            padded[:W] = prev_tail_cls
        padded[W:W + n] = cls
        win = sliding_window_view(padded, J)[::K][:Cp]   # [Cp, J] view

        # pack CPW BITS-bit classes/word; chunk c = ((b*G+g)*TILE+t)
        arr = np.ascontiguousarray(win).reshape(B, G, TILE,
                                                J // CPW, CPW)
        if tables.bits == 4:
            nib = (arr[..., 0::2] | (arr[..., 1::2] << 4))
            words = np.ascontiguousarray(nib).view("<u4")[..., 0] \
                .astype(np.int32)
        else:
            # 3-bit (10/word) or 8-bit (4/word, ncls > 16) packing
            words = arr[..., 0].astype(np.int32).copy()
            for k in range(1, CPW):
                words |= arr[..., k].astype(np.int32) \
                    << (tables.bits * k)
        packed = np.ascontiguousarray(words.transpose(0, 3, 1, 2))
        packed = packed.reshape(B, J // CPW, G, 8, 128)
    # commit to the device here so repeated scans skip the upload
    dev = jnp.asarray(packed)
    if block:
        dev.block_until_ready()
    return dev, C, K, J, B


def _prepare_pair(tables, raw, n, K, W, G, C, B, Cp, J,
                  prev_tail_cls=None, block=True):
    """Pair-unit host prep (ops/pallas_pair.py tables): class-map the
    whole stream, combine adjacent classes into pair ids (K and W are
    even, so pairs never straddle a window), then window/pack in pair
    units with the same layout as _prepare."""
    from numpy.lib.stride_tricks import sliding_window_view

    CPW = tables.cpw
    cb = tables.byte_ncls
    cls = np.frombuffer(
        raw.tobytes().translate(tables.class_map.tobytes()),
        dtype=np.uint8)
    padded = np.zeros(W + Cp * K, dtype=np.uint8)
    if prev_tail_cls is not None:
        padded[:W] = prev_tail_cls
    padded[W:W + n] = cls
    pairs = (padded[0::2].astype(np.int16) * cb
             + padded[1::2]).astype(np.uint8)
    K2, W2, J2 = K // 2, W // 2, J // 2
    win = sliding_window_view(pairs, J2)[::K2][:Cp]

    arr = np.ascontiguousarray(win).reshape(B, G, TILE,
                                            J2 // CPW, CPW)
    if tables.bits == 4:
        nib = (arr[..., 0::2] | (arr[..., 1::2] << 4))
        words = np.ascontiguousarray(nib).view("<u4")[..., 0] \
            .astype(np.int32)
    else:
        words = arr[..., 0].astype(np.int32).copy()
        for k in range(1, CPW):
            words |= arr[..., k].astype(np.int32) << (tables.bits * k)
    packed = np.ascontiguousarray(words.transpose(0, 3, 1, 2))
    packed = packed.reshape(B, J2 // CPW, G, 8, 128)
    dev = jnp.asarray(packed)
    if block:
        dev.block_until_ready()
    return dev, C, K, J, B


@functools.partial(jax.jit, static_argnames=("B",))
def _entry_planes(entry_premult, w, *, B):
    """Device-built state0/j0 planes: all streams speculate from the
    premultiplied seed except stream 0, which starts at the true
    entry with its warmup frozen (j0 = W).  Building these on device
    replaces a 2 x B x 4096 x 4-byte host upload per scan (~8 MB at
    a 2 GiB corpus, pure overhead)."""
    G = GROUPS
    s0 = jnp.zeros((B, G, 8, 128), jnp.int32)
    s0 = s0.at[0, 0, 0, 0].set(entry_premult)
    j0 = jnp.zeros((B, G, 8, 128), jnp.int32)
    j0 = j0.at[0, 0, 0, 0].set(w)
    return s0, j0


def spec_scan_bytes(tables, data_np, chunk_len=DEFAULT_K,
                    entry_state=0, prepared=None, mesh=None,
                    axis="data"):
    """Whole-buffer scan.  Returns (final_state, first_match_boundary
    or -1); boundaries 0..n-1 only, the EOF boundary is the caller's
    (tables.match_eof).  Exact: speculation misses and firing chunks
    are re-scanned with the native engine.  On a match the returned
    state is the state AT the match boundary (so the regex id is
    tables.dfa.id_at(state, data[boundary]) — ids never ride the
    device hot loop).

    ``prepared`` may carry the result of a prior _prepare() to skip
    host preprocessing (benchmarks, repeated scans)."""
    from ..native import NativeDfa

    n = len(data_np)
    if n == 0:
        return entry_state, -1
    W = tables.warmup
    if prepared is None:
        from .prep import prepare_auto
        prepared = prepare_auto(tables, data_np, chunk_len,
                                b_multiple=(mesh.devices.size
                                            if mesh is not None else 1))
    data, C, K, J, B = prepared
    ncls = tables.ncls
    G = GROUPS
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)

    # chunk 0: skip warmup entirely, start from the true entry state
    s0p, j0p = _entry_planes(jnp.int32(topm(entry_state)),
                             jnp.int32(W), B=B)

    bad_tail = (C - 1) if C * K > n and (n - (C - 1) * K) != K else -1
    summary, packed = tables._scan(
        data if isinstance(data, jax.Array) else jnp.asarray(data),
        s0p, j0p,
        jnp.int32(C), jnp.int32(bad_tail), J, W, mesh=mesh,
        axis=axis if mesh is not None else None)
    # common case: ~32-byte readback; the per-chunk arrays stay on
    # device and are pulled only for the repair path
    summ = np.asarray(summary).astype(np.int64)
    all_ok, fb = bool(summ[0]), int(summ[1])
    tables.last_repair = None   # set on completed (no-match) scans
    if all_ok:
        tables.last_repair = (0, C)
        return frpm(int(summ[6])), -1

    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    native = NativeDfa(tables.dfa)
    entry_fb, phi_fb, swarm_fb, many_fb = (int(summ[2]), int(summ[3]),
                                           int(summ[4]), int(summ[5]))
    lo = fb * K
    hi = min(lo + K, n)
    if swarm_fb == entry_fb and hi - lo == K and many_fb:
        # validated chunk fired a match: one native re-scan pins it
        f, st = native.scan_first(raw[lo:hi].tobytes(),
                                  frpm(entry_fb))
        return st, lo + f

    # general repair (speculation miss / ragged tail): pull the
    # per-chunk arrays and walk sequentially from the discrepancy
    phi, many, swarm = _unpack(packed, C)
    e = entry_fb
    c = fb
    nat = 0
    while c < C:
        lo = c * K
        hi = min(lo + K, n)
        if swarm[c] == e and hi - lo == K and many[c] == 0:
            e = int(phi[c])
            c += 1
            continue
        f, st = native.scan_first(raw[lo:hi].tobytes(), frpm(e))
        if f >= 0:
            return st, lo + f
        e = topm(st)
        c += 1
        nat += 1
    tables.last_repair = (nat, C)
    return frpm(e), -1


def spec_count_bytes(tables, data_np, chunk_len=DEFAULT_K,
                     entry_state=0, prepared=None, mesh=None,
                     axis="data"):
    """Count every boundary (0..n-1) at which a match ends.  Returns
    (final_state, count); the EOF boundary is the caller's
    (tables.match_eof).  Exact: chunks whose speculation missed are
    re-counted with the native engine."""
    from ..native import NativeDfa

    n = len(data_np)
    if n == 0:
        return entry_state, 0
    W = tables.warmup
    if prepared is None:
        from .prep import prepare_auto
        prepared = prepare_auto(tables, data_np, chunk_len,
                                b_multiple=(mesh.devices.size
                                            if mesh is not None else 1))
    data, C, K, J, B = prepared
    ncls = tables.ncls
    G = GROUPS
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)

    s0p, j0p = _entry_planes(jnp.int32(topm(entry_state)),
                             jnp.int32(W), B=B)

    bad_tail = (C - 1) if C * K > n and (n - (C - 1) * K) != K else -1
    summary, packed = tables._scan(
        data if isinstance(data, jax.Array) else jnp.asarray(data),
        s0p, j0p,
        jnp.int32(C), jnp.int32(bad_tail), J, W, COUNT=True,
        mesh=mesh, axis=axis if mesh is not None else None)
    summ = np.asarray(summary).astype(np.int64)
    if bool(summ[0]):
        # every chunk validated: in COUNT mode fb saturates past C, so
        # the prefix sum covers the whole corpus.  The device summary
        # accumulates in int32; past 2**31-1 possible boundaries the
        # exact total is re-summed on host in int64 from the per-chunk
        # counts (a ~4*C-byte readback, only for >2 GiB corpora).
        tables.last_repair = (0, C)
        if n < 2 ** 31:
            return frpm(int(summ[6])), int(summ[7])
        _, cnt, _ = _unpack(packed, C)
        return frpm(int(summ[6])), int(np.sum(cnt, dtype=np.int64))

    # repair from the first speculation miss (or ragged tail)
    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    fb = int(summ[1])
    total = int(summ[7])          # counts of the validated prefix
    native = NativeDfa(tables.dfa)
    phi, cnt, swarm = _unpack(packed, C)
    e = int(summ[2])
    c = fb
    nat = 0
    while c < C:
        lo = c * K
        hi = min(lo + K, n)
        if swarm[c] == e and hi - lo == K:
            total += int(cnt[c])
            e = int(phi[c])
        else:
            k, st = native.count(raw[lo:hi].tobytes(), frpm(e))
            total += k
            e = topm(st)
            nat += 1
        c += 1
    tables.last_repair = (nat, C)
    return frpm(e), total


def spec_chunk_map(tables, data_np, chunk_len=DEFAULT_K,
                   entry_state=0, prepared=None, mesh=None,
                   axis="data"):
    """Validated per-chunk scan map: (entries [C], counts [C],
    final_state), all exact.

    entries[c] = the DFA state entering chunk c (plain ids), counts[c]
    = the number of match-ending boundaries inside chunk c.  One
    COUNT-mode device pass; chunks whose speculation missed (or the
    ragged tail) are re-counted natively.  This is the building block
    for device-rate finditer: the per-chunk fire map says which chunks
    can contain match boundaries at all, and the entries let the
    caller re-scan any single chunk natively for exact positions.
    """
    from ..native import NativeDfa

    n = len(data_np)
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                entry_state)
    W = tables.warmup
    if prepared is None:
        from .prep import prepare_auto
        prepared = prepare_auto(tables, data_np, chunk_len,
                                b_multiple=(mesh.devices.size
                                            if mesh is not None else 1))
    data, C, K, J, B = prepared
    ncls = tables.ncls
    G = GROUPS
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)

    s0p, j0p = _entry_planes(jnp.int32(topm(entry_state)),
                             jnp.int32(W), B=B)

    bad_tail = (C - 1) if C * K > n and (n - (C - 1) * K) != K else -1
    summary, packed = tables._scan(
        data if isinstance(data, jax.Array) else jnp.asarray(data),
        s0p, j0p,
        jnp.int32(C), jnp.int32(bad_tail), J, W, COUNT=True,
        mesh=mesh, axis=axis if mesh is not None else None)
    summ = np.asarray(summary).astype(np.int64)
    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    phi, cnt, swarm = _unpack(packed, C)
    entries = np.zeros(C, dtype=np.int64)
    counts = cnt.astype(np.int64).copy()
    native = None
    fb = C if bool(summ[0]) else int(summ[1])
    # validated prefix: the chain is exact as-is
    e = topm(entry_state)
    for c in range(min(fb, C)):
        entries[c] = e
        e = int(phi[c])
    c = fb
    while c < C:
        lo = c * K
        hi = min(lo + K, n)
        entries[c] = e
        if swarm[c] == e and hi - lo == K:
            e = int(phi[c])
        else:
            if native is None:
                native = NativeDfa(tables.dfa)
            k, st = native.count(raw[lo:hi].tobytes(), frpm(e))
            counts[c] = k
            e = topm(st)
        c += 1
    frv = getattr(tables, "from_premult_vec", None)
    ents = entries // ncls if frv is None else frv(entries)
    return ents, counts, frpm(e)


def spec_scan_last_bytes(tables, data_np, chunk_len=DEFAULT_K,
                         entry_state=0, prepared=None, mesh=None,
                         axis="data"):
    """Find the LAST boundary (0..n-1) at which a match ends (used by
    the reverse-scan start locator).  Returns (final_state,
    last_boundary or -1).  Exact via the same speculation validation."""
    from ..native import NativeDfa

    n = len(data_np)
    if n == 0:
        return entry_state, -1
    W = tables.warmup
    if prepared is None:
        from .prep import prepare_auto
        prepared = prepare_auto(tables, data_np, chunk_len,
                                b_multiple=(mesh.devices.size
                                            if mesh is not None else 1))
    data, C, K, J, B = prepared
    ncls = tables.ncls
    G = GROUPS
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)

    s0p, j0p = _entry_planes(jnp.int32(topm(entry_state)),
                             jnp.int32(W), B=B)

    bad_tail = (C - 1) if C * K > n and (n - (C - 1) * K) != K else -1
    summary, packed = tables._scan(
        data if isinstance(data, jax.Array) else jnp.asarray(data),
        s0p, j0p,
        jnp.int32(C), jnp.int32(bad_tail), J, W, COUNT=True,
        mesh=mesh, axis=axis if mesh is not None else None)
    summ = np.asarray(summary).astype(np.int64)
    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    native = NativeDfa(tables.dfa)

    if bool(summ[0]):
        last_fire = int(summ[8])
        if last_fire < 0:
            return frpm(int(summ[6])), -1
        lo = last_fire * K
        r, _ = native.scan_last(raw[lo:lo + K].tobytes(),
                                frpm(int(summ[9])))
        return frpm(int(summ[6])), lo + r

    # repair path: walk from the first discrepancy, tracking the last
    # fire exactly; the device summary covers the validated prefix
    fb = int(summ[1])
    best = -1
    if int(summ[8]) >= 0:
        lo = int(summ[8]) * K
        r, _ = native.scan_last(raw[lo:lo + K].tobytes(),
                                frpm(int(summ[9])))
        best = lo + r
    phi, cnt, swarm = _unpack(packed, C)
    e = int(summ[2])
    c = fb
    while c < C:
        lo = c * K
        hi = min(lo + K, n)
        if swarm[c] == e and hi - lo == K:
            if cnt[c]:
                r, _ = native.scan_last(raw[lo:hi].tobytes(), frpm(e))
                best = lo + r
            e = int(phi[c])
        else:
            r, st = native.scan_last(raw[lo:hi].tobytes(), frpm(e))
            if r >= 0:
                best = lo + r
            e = topm(st)
        c += 1
    return frpm(e), best
