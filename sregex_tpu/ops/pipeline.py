"""Pipelined streaming device scan: overlap host->device uploads with
the device walk across corpus SEGMENTS.

The single-buffer drivers (spec_scan_bytes / spec_count_bytes,
ops/pallas_scan.py) prepare the whole corpus, then scan it — on cold
data the host->device upload serializes ahead of the walk.  Here the
corpus arrives as an iterable of segments (file reads, network
chunks); each segment is prepared and its kernel dispatched WITHOUT
blocking, so JAX's async dispatch runs segment i's scan while segment
i+1's bytes are still DMA-ing up.  Only the fold (a per-segment
readback of the ~4-bytes-per-chunk repair planes) synchronizes, and
it runs one segment behind the uploads.

Cross-segment exactness is the same speculation-validation argument
as the in-segment chunk chain (pallas_scan.py module docstring):

  - a non-first segment's chunk 0 gets a REAL warmup window — the
    last W bytes of the previous segment (threaded into the prep via
    prev_tail_cls) — and speculates from the seed state like every
    interior chunk;
  - at fold time the true entry state of each segment is known (it is
    the previous segment's validated exit), so the host validates
    swarm[0] == entry exactly as it validates interior chunks, and
    re-scans mismatched or ragged chunks with the native engine.

Segments of any size compose: a ragged final chunk inside a non-final
segment is repaired natively (bad_tail), and its exact exit state
feeds the next segment's validation.  For pair-unit tables (bpu=2) an
odd trailing byte is held back and prepended to the next segment so
pair alignment is preserved stream-wide.

This is the streaming ingestion pattern of the reference's chunked
`sre_vm_pike_exec` protocol (sre_vm_pike.c:148-235: feed chunks,
carry the ctx) lifted to device rate: the "ctx" between segments is
one DFA state, and the chunk-boundary carry is the validation chain.
"""

from collections import deque

import numpy as np
import jax.numpy as jnp

from .pallas_scan import DEFAULT_K, _entry_planes, _unpack
from .prep import prepare_auto

# default number of segments in flight before the oldest is folded
# (2 = classic double buffering: fold segment i while i+1 executes
# and i+2 uploads)
IN_FLIGHT = 2


def _as_np(seg):
    if isinstance(seg, np.ndarray):
        return seg
    return np.frombuffer(seg, dtype=np.uint8)


def _fold_count(native, raw, n, C, K, ncls, phi, cnt, swarm, e,
                topm=None, frpm=None):
    """Validate one segment's chunk chain from the true entry
    (premultiplied) ``e``; returns (exit_premult, segment_count,
    natively_repaired_chunks).  Vectorized in the common all-validated
    case; mismatched or ragged chunks re-count natively."""
    topm = topm or (lambda v: v * ncls)
    frpm = frpm or (lambda v: v // ncls)
    ragged = C * K > n
    pred = np.concatenate(([e], phi[:-1]))
    ok = swarm == pred
    if ragged:
        ok[C - 1] = False
    if ok.all():
        return int(phi[-1]), int(np.sum(cnt, dtype=np.int64)), 0
    # by induction the prefix before the first failure is exact
    fb = int(np.argmin(ok))
    total = int(np.sum(cnt[:fb], dtype=np.int64))
    e = int(pred[fb])
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
    return int(e), total, nat


def _fold_first(native, raw, n, C, K, ncls, phi, fm, swarm, e,
                topm=None, frpm=None):
    """Validate one segment's chain from entry ``e`` looking for the
    FIRST match boundary.  Returns (exit_premult, rel_boundary or -1,
    natively_repaired_chunks); on a match the exit is the state AT
    the boundary (spec_scan_bytes contract)."""
    topm = topm or (lambda v: v * ncls)
    frpm = frpm or (lambda v: v // ncls)
    ragged = C * K > n
    pred = np.concatenate(([e], phi[:-1]))
    ok = (swarm == pred) & (fm == 0)
    if ragged:
        ok[C - 1] = False
    if ok.all():
        return int(phi[-1]), -1, 0
    fb = int(np.argmin(ok))
    e = int(pred[fb])
    c = fb
    nat = 0
    while c < C:
        lo = c * K
        hi = min(lo + K, n)
        if swarm[c] == e and hi - lo == K and fm[c] == 0:
            e = int(phi[c])
            c += 1
            continue
        f, st = native.scan_first(raw[lo:hi].tobytes(), frpm(e))
        if f >= 0:
            return topm(st), lo + f, nat
        e = topm(st)
        c += 1
        nat += 1
    return int(e), -1, nat


def _fold_core_count(ct, packed, raw, n, C, K, e_full):
    """Core-tier segment fold (count): same trusted-run walk as
    core_count_bytes, from the segment's true FULL entry state.
    Returns (exit_full, count, natively_repaired_chunks)."""
    from .pallas_core import _Fold
    fold = _Fold(ct, packed, C, K, n, quiet=False)
    total = 0
    nat = 0
    c = 0
    while c < C:
        if fold.trusted(c, e_full):
            b = fold.run_end(c)
            total += fold.run_count(c, b)
            e_full = ct.to_full(int(fold.phi[b]))
            c = b + 1
            continue
        lo = c * K
        hi = min(lo + K, n)
        k, st = ct.native.count(raw[lo:hi].tobytes(), e_full)
        total += k
        e_full = st
        c += 1
        nat += 1
    return e_full, total, nat


def _fold_core_first(ct, packed, raw, n, C, K, e_full):
    """Core-tier segment fold (first match): fired, escaped, or
    speculation-missed chunks re-scan natively on the FULL machine.
    Returns (exit_full_or_state_at_boundary, rel_boundary or -1,
    natively_repaired_chunks)."""
    from .pallas_core import _Fold
    fold = _Fold(ct, packed, C, K, n, quiet=True)
    c = 0
    nat = 0
    while c < C:
        if fold.trusted(c, e_full):
            b = fold.run_end(c)
            e_full = ct.to_full(int(fold.phi[b]))
            c = b + 1
            continue
        lo = c * K
        hi = min(lo + K, n)
        f, st = ct.native.scan_first(raw[lo:hi].tobytes(), e_full)
        if f >= 0:
            return st, lo + f, nat
        e_full = st
        c += 1
        nat += 1
    return e_full, -1, nat


class _Pipeline:
    """Shared dispatch/fold machinery for the pipelined drivers.

    Serves the static tiers (SpecTables / wide / pair / big: state
    carry in premultiplied table space) AND the adaptive core tier
    (CoreTables / LazyCoreTables, detected by esc_premult: kernels
    run the inner core tables, the carry is a FULL-machine state, and
    folds reuse the core's trusted-run walk with native full-machine
    repair — the sticky-ESC argument is segment-size-agnostic)."""

    def __init__(self, tables, chunk_len, entry_state, count_mode,
                 in_flight, mesh):
        self.ct = tables if hasattr(tables, "esc_premult") else None
        inner = tables.inner if self.ct is not None else tables
        self.tables = inner
        self.chunk_len = chunk_len
        self.count_mode = count_mode
        self.in_flight = max(1, int(in_flight))
        self.mesh = mesh
        self.ncls = inner.ncls
        self.W = inner.warmup
        self.bpu = getattr(inner, "bpu", 1)
        self.cm = inner.class_map.tobytes()
        if self.ct is not None:
            self.native = self.ct.native      # the FULL machine
            self.e_full = entry_state         # full-state carry
            self.ct.last_repair = None        # set on completed folds
        else:
            from ..native import NativeDfa
            self.native = NativeDfa(inner.dfa)
            self.topm = getattr(inner, "to_premult", None) \
                or (lambda v: v * self.ncls)
            self.frpm = getattr(inner, "from_premult", None) \
                or (lambda v: v // self.ncls)
            self.e = self.topm(entry_state)  # premultiplied carry
        self.b_mult = mesh.devices.size if mesh is not None else 1
        self.total = 0
        self.first_abs = -1
        self.first_byte = -1               # byte AT the boundary
        self.base = 0                      # absolute offset folded
        self.nat = 0                       # natively repaired chunks
        self.nchunks = 0
        self.tail = b""                    # last <= W raw stream bytes
        self.first_seg = True
        self.pending = deque()

    def dispatch(self, seg):
        """Prepare + enqueue one segment's kernel without blocking."""
        if not isinstance(seg, bytes):
            # snapshot: the fold re-reads this segment's raw bytes up
            # to in_flight segments later (validation + native
            # repair); a producer that reuses its read buffer
            # (readinto / refilled ndarray — the file/network
            # streaming pattern) must not be able to mutate bytes the
            # fold hasn't consumed yet
            seg = bytes(seg)
        n = len(seg)
        if self.first_seg:
            tail_cls = None
        else:
            t = np.zeros(self.W, dtype=np.uint8)
            mapped = np.frombuffer(self.tail.translate(self.cm),
                                   dtype=np.uint8)
            if len(mapped):
                t[self.W - len(mapped):] = mapped
            tail_cls = t
        data, C, K, J, B = prepare_auto(
            self.tables, _as_np(seg), self.chunk_len,
            b_multiple=self.b_mult, prev_tail_cls=tail_cls,
            block=False)
        frozen = None
        if self.first_seg:
            if self.ct is None:
                frozen = self.e
            else:
                # core mode: the entry can be frozen only if it is a
                # hot state; otherwise chunk 0 speculates and the
                # fold repairs it natively (exactness unconditional)
                ep = self.ct.to_core_premult(self.e_full)
                if ep >= 0:
                    frozen = ep
        if frozen is not None:
            # exact entry, warmup frozen (the single-buffer protocol)
            s0p, j0p = _entry_planes(jnp.int32(frozen),
                                     jnp.int32(self.W), B=B)
        else:
            # chunk 0 speculates over the real prev-segment tail;
            # validation against the true entry happens at fold time
            s0p, j0p = _entry_planes(jnp.int32(0), jnp.int32(0), B=B)
        bad_tail = (C - 1) if C * K > n and (n - (C - 1) * K) != K \
            else -1
        _summary, packed = self.tables._scan(
            data, s0p, j0p, jnp.int32(C), jnp.int32(bad_tail), J,
            self.W, COUNT=self.count_mode,
            esc=self.ct.esc_premult if self.ct is not None else None,
            mesh=self.mesh,
            axis="data" if self.mesh is not None else None)
        self.first_seg = False
        self.tail = (self.tail + bytes(seg[-self.W:]))[-self.W:]
        self.pending.append((packed, seg, C, K, n))
        while len(self.pending) > self.in_flight:
            self.fold_one()

    def fold_one(self):
        if self.done_early:
            # the earliest match is already pinned: later segments'
            # results are past it by construction (the fold is FIFO)
            self.pending.clear()
            return
        packed, seg, C, K, n = self.pending.popleft()
        raw = _as_np(seg)
        self.nchunks += C
        if self.ct is not None:
            if self.count_mode:
                self.e_full, add, nat = _fold_core_count(
                    self.ct, packed, raw, n, C, K, self.e_full)
                self.total += add
                self.nat += nat
            else:
                self.e_full, rel, nat = _fold_core_first(
                    self.ct, packed, raw, n, C, K, self.e_full)
                self.nat += nat
                if rel >= 0:
                    self.first_abs = self.base + rel
                    self.first_byte = int(raw[rel])
            self.base += n
            return
        phi, fmcnt, swarm = _unpack(packed, C)
        if self.count_mode:
            self.e, add, nat = _fold_count(self.native, raw, n, C, K,
                                           self.ncls, phi, fmcnt,
                                           swarm, self.e,
                                           topm=self.topm,
                                           frpm=self.frpm)
            self.total += add
            self.nat += nat
        else:
            self.e, rel, nat = _fold_first(self.native, raw, n, C, K,
                                           self.ncls, phi, fmcnt,
                                           swarm, self.e,
                                           topm=self.topm,
                                           frpm=self.frpm)
            self.nat += nat
            if rel >= 0:
                self.first_abs = self.base + rel
                self.first_byte = int(raw[rel])
        self.base += n

    def drain(self):
        while self.pending:
            self.fold_one()
            if not self.count_mode and self.first_abs >= 0:
                self.pending.clear()

    @property
    def done_early(self):
        return not self.count_mode and self.first_abs >= 0


def _run(tables, segments, chunk_len, entry_state, count_mode,
         in_flight, mesh):
    pipe = _Pipeline(tables, chunk_len, entry_state, count_mode,
                     in_flight, mesh)
    holdback = b""
    for seg in segments:
        if pipe.bpu == 2:
            # pair-unit tables: keep the stream pair-aligned by
            # holding an odd trailing byte for the next segment
            seg = holdback + bytes(seg)
            holdback = b""
            if len(seg) % 2:
                holdback = seg[-1:]
                seg = seg[:-1]
        if len(seg) == 0:
            continue
        pipe.dispatch(seg)
        if pipe.done_early:
            break
    if holdback and not pipe.done_early:
        pipe.dispatch(holdback)
    pipe.drain()
    # observability: total bytes folded (== stream length unless a
    # first-match fold exited early), read by Scanner.stats()
    (pipe.ct if pipe.ct is not None
     else pipe.tables).last_fold_bytes = pipe.base
    if pipe.ct is not None:
        # completed (no-early-exit) scans feed the Scanner's
        # drift/re-core logic; early-match scans leave stats None
        # like core_scan_bytes' matched path (their fold stops at
        # the match, so repair fractions would be meaningless)
        if count_mode:
            pipe.ct.last_repair = (pipe.nat, max(pipe.nchunks, 1))
            return pipe.e_full, pipe.total
        if pipe.first_abs < 0:
            pipe.ct.last_repair = (pipe.nat, max(pipe.nchunks, 1))
        return (pipe.e_full, pipe.first_abs, pipe.first_byte,
                pipe.base)
    # static tiers: same stats convention (Scanner.stats() reads it)
    if count_mode or pipe.first_abs < 0:
        pipe.tables.last_repair = (pipe.nat, max(pipe.nchunks, 1))
    else:
        pipe.tables.last_repair = None
    if count_mode:
        return pipe.frpm(pipe.e), pipe.total
    return (pipe.frpm(pipe.e), pipe.first_abs, pipe.first_byte,
            pipe.base)


def pipelined_count(tables, segments, chunk_len=DEFAULT_K,
                    entry_state=0, in_flight=IN_FLIGHT, mesh=None):
    """Count every interior match boundary across a SEGMENTED stream.
    Equivalent to spec_count_bytes on the concatenation, without ever
    materializing it; uploads overlap scans.  Returns (final_state,
    count) — the EOF boundary is the caller's (tables.match_eof).

    ``tables`` may be a static tier (SpecTables/wide/pair/big) or the
    adaptive core tier (CoreTables/LazyCoreTables); entry and final
    states are always FULL-machine state ids."""
    return _run(tables, segments, chunk_len, entry_state, True,
                in_flight, mesh)


def pipelined_scan(tables, segments, chunk_len=DEFAULT_K,
                   entry_state=0, in_flight=IN_FLIGHT, mesh=None):
    """First match boundary across a SEGMENTED stream.  Equivalent to
    spec_scan_bytes on the concatenation: returns (state, boundary or
    -1, byte_at_boundary or -1, bytes_folded) with the state AT the
    boundary on a match (so the regex id is dfa.id_at(state, byte)).
    bytes_folded is the total stream length when no match was found
    (the EOF-boundary case); on an early match it only covers the
    folded prefix.  Segments already dispatched when the match folds
    are discarded unfolded."""
    return _run(tables, segments, chunk_len, entry_state, False,
                in_flight, mesh)
