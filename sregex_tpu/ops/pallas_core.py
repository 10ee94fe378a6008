"""Adaptive hot-core tier: big automata at narrow-table cost.

The big-table tier (ops/pallas_big.py) walks a table of up to 2^17
entries that no longer fits the GPU's L1 once it grows past a few
thousand entries.  But DFA scans over real data visit a tiny, heavily skewed subset of
the state space: a counted-repetition monster with 4,818 states
typically cycles through a handful of them outside rare match
regions.  The reference exploits the same skew with its leading-bytes
memchr prefilter (sre_vm_pike.c:256-308); here the whole SCAN runs on
the skew.

Mechanics (everything reuses the speculative-scan machinery):

  1. sample the corpus and count per-state visits with one native
     table walk (csrc/sre_host.cpp sre_dfa_visits);
  2. synthesize a CORE machine over the visited states + one sticky
     ESC state (dfa.build_core_dfa): out-of-core transitions divert to
     ESC, ESC transitions carry the match bit, and byte classes
     re-merge over the hot rows (usually collapsing far below the full
     machine's alphabet);
  3. run the ordinary pair/narrow/wide walk over the core tables.
     A chunk that never escapes behaves exactly like the full machine;
     a chunk that escapes exits in ESC and _summarize's ESC check
     fails its validation, so the host repairs it with the FULL
     machine (native C++ scan) — the same repair protocol that already
     handles speculation misses.  Exactness is therefore unconditional
     and does NOT depend on the sample being representative; a bad
     sample only costs speed.

The sticky-ESC argument that makes per-chunk trust sound: core
transitions agree with the full machine while the trajectory stays in
the hot set, and any departure lands in ESC, which only self-loops —
so exit != ESC  <=>  the whole chunk ran inside the core  =>  the
chunk's exit state and match bits are the full machine's.

This tier replaces nothing: Scanner tries it only where the static
tier chain bottoms out at SpecTablesBig (or no device tier at all),
and any pattern/corpus where no small core covers the sampled mass
stays on the big tier (CoreTables raises ValueError).
"""

import functools
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from ..dfa import build_core_dfa
from .pallas_scan import (SpecTables, SpecTablesWide, DEFAULT_K,
                          GROUPS, _entry_planes, _unpack)
from .scan_kernel import implementation, walk

# sampled visit mass allowed OUTSIDE the core (per byte): an escape
# costs one native chunk re-scan on the host, far more than the
# chunk's device walk, so the allowance is small.
MAX_ESCAPE_FRAC = 1e-5

# candidate hot-set sizes tried (descending): the largest FAST-tier
# (pair/narrow) fit wins, else the largest wide fit
_CANDIDATE_MS = (4096, 2048, 1024, 512, 256, 128, 96, 64, 48, 32, 24,
                 16, 12, 8, 6, 4, 3, 2, 1)


def _inner_tables(core, narrow_only, no_pair=False):
    """Fast-first tier chain over the synthesized core machine.
    narrow_only=True restricts to the 1-gather tiers (pair/narrow);
    False also admits the row-select wide tier (<= 4096 entries).
    no_pair=True keeps the pair tier out — the FUSED two-phase path
    needs a byte-unit inner whose chunking matches the full tables
    (pair units would disqualify the merged validation)."""
    import functools
    chain = []
    if not no_pair and os.environ.get("SREGEX_PAIR") != "0":
        from .pallas_pair import SpecTablesPair
        chain.append(functools.partial(SpecTablesPair,
                                       narrow_only=True))
    chain.append(SpecTables)
    if not narrow_only:
        chain.append(SpecTablesWide)
    for cls in chain:
        try:
            return cls(core)
        except ValueError:
            continue
    return None


class CoreTables:
    """Hot-core tables for one (full automaton, corpus sample) pair.

    Raises ValueError when no worthwhile core exists: the sampled
    visit mass cannot be covered (within MAX_ESCAPE_FRAC) by a state
    subset small enough for the pair/narrow/wide kernels.
    """

    def __init__(self, dfa, sample, max_escape_frac=MAX_ESCAPE_FRAC,
                 require_fast=False, no_pair=False,
                 prefer_small=False):
        """require_fast=True only accepts a core the 1-gather
        (pair/narrow) tiers can run — used when the FULL machine
        already has a static wide tier, which a wide core could
        never beat.  no_pair=True restricts to byte-unit inners
        (the fused path's chunking constraint).

        prefer_small=True picks the SMALLEST hot set above the mass
        floor instead of the largest fit — the FUSED path's policy
        (round 5): its escapes cost a device redo, not a native host
        walk, so the gain of a smaller machine (a smaller table stays
        closer to the cores; a small core can drop to the narrow
        tier) is worth a higher escape rate.  On the 90-keyword bench
        shape the legacy largest-fit core is 118 states -> rows 23
        wide; the small-fit core is narrow."""
        from ..native import NativeDfa
        self.dfa = dfa                      # the FULL machine
        self.native = NativeDfa(dfa)
        counts, _ = self.native.visits(sample, 0)
        total = float(counts.sum())
        if total <= 0:
            raise ValueError("empty sample")
        counts = counts.copy()
        counts[0] += 1                      # entry state is always hot
        visited = np.nonzero(counts)[0]
        order = visited[np.argsort(-counts[visited], kind="stable")]
        order = np.concatenate([[0], order[order != 0]])
        V = len(order)
        csum = np.cumsum(counts[order].astype(np.float64))
        allowed = max_escape_frac * total
        # covering the whole visited set (zero escapes) always
        # qualifies — clamp, or a sub-1-visit allowance (small
        # samples) would reject every candidate
        m_min = min(V, int(np.searchsorted(csum,
                                           total + 1 - allowed)) + 1)
        ms = sorted({m for m in (V,) + _CANDIDATE_MS
                     if m_min <= m <= V}, reverse=True)

        fast_fit = None                     # (inner, core, maps)
        wide_fit = None
        for m in ms:
            core, hot2full, full2core = build_core_dfa(dfa, order[:m])
            if fast_fit is None:
                inner = _inner_tables(core, narrow_only=True,
                                      no_pair=no_pair)
                if inner is not None:
                    fast_fit = (inner, core, hot2full, full2core)
                    break                   # largest fast fit wins
                    # (among fast fits more states = fewer
                    # escapes on the same narrow table)
            if not require_fast:
                inner = _inner_tables(core, narrow_only=False,
                                      no_pair=no_pair)
                if inner is not None and (wide_fit is None
                                          or prefer_small):
                    # legacy keeps the FIRST (largest) wide fit:
                    # escapes cost a native host walk there, so
                    # coverage wins.  prefer_small overwrites down
                    # to the SMALLEST wide fit: smaller tables walk
                    # faster and the fused path redoes escapes on
                    # device
                    wide_fit = (inner, core, hot2full, full2core)
        fit = fast_fit or wide_fit
        if fit is None:
            raise ValueError("no fast core tier fits the sampled "
                             "hot set (visited %d states)" % V)
        self.inner, self.core, self.hot2full, self.full2core = fit
        self.H = len(self.hot2full)
        # set by each COMPLETED scan: (natively repaired chunks, C).
        # None after an early-returning scan (first-match fast exit).
        # Scanner reads this to detect corpus drift and re-core.
        self.last_repair = None
        # premultiplied sticky-escape id in the INNER alphabet (the
        # pair tier premultiplies by ncls^2)
        self.esc_premult = self.H * self.inner.ncls

    # ---- core premult <-> full state id ----

    def to_core_premult(self, full_state):
        """Premultiplied core id of a full state, or -1 if not hot."""
        c = int(self.full2core[full_state])
        if c >= self.H:
            return -1
        return c * self.inner.ncls

    def to_full(self, core_premult):
        """Full state id of a (non-ESC) premultiplied core id."""
        return int(self.hot2full[core_premult // self.inner.ncls])

    def to_full_vec(self, premult_arr):
        """Vectorized to_full over an array of non-ESC premult ids."""
        return self.hot2full[np.asarray(premult_arr) // self.inner.ncls]


class _LazyNative:
    """Full-machine adapter over a LazyDfa with the scan signatures
    the repair folds call on NativeDfa."""

    def __init__(self, lazy):
        self.lazy = lazy

    def scan_first(self, data, entry):
        return self.lazy.scan_first(data, entry)

    def count(self, data, entry):
        return self.lazy.count(data, entry)

    def scan_last(self, data, entry):
        return self.lazy.scan_last(data, entry)


class LazyCoreTables:
    """Adaptive hot-core tier over a LazyDfa full machine: gives
    patterns past the eager DFA budget (>8,192 states, where no dense
    machine exists at all) a fast device path.  The reference's JIT
    compiles every program (sre_vm_thompson_jit.c:39); with this, so
    do the fast kernels — only the tiny hot core is ever materialized
    as tables, and escapes repair on the lazy machine (Python walk,
    so drifted corpora are slower than the dense tier — the Scanner's
    re-core/decline logic bounds that).

    Duck-typed to CoreTables for core_scan_bytes / core_count_bytes
    (full states are lazy sids; full2core is a dict)."""

    def __init__(self, lazy, sample, max_escape_frac=MAX_ESCAPE_FRAC,
                 require_fast=False):
        self.lazy = lazy
        self.dfa = lazy          # id_at/match_eof duck-typing
        self.native = _LazyNative(lazy)
        counts, _ = lazy.visits(sample, 0)
        counts[0] = counts.get(0, 0) + 1    # entry is always hot
        total = float(sum(counts.values()))
        order = [0] + sorted((s for s in counts if s != 0),
                             key=lambda s: (-counts[s], s))
        V = len(order)
        csum = np.cumsum([counts[s] for s in order]).astype(np.float64)
        allowed = max_escape_frac * total
        # covering the whole visited set (zero escapes) always
        # qualifies — clamp, or a sub-1-visit allowance (small
        # samples) would reject every candidate
        m_min = min(V, int(np.searchsorted(csum,
                                           total + 1 - allowed)) + 1)
        ms = sorted({m for m in (V,) + _CANDIDATE_MS
                     if m_min <= m <= V}, reverse=True)

        fast_fit = None
        wide_fit = None
        for m in ms:
            core = self._build(order[:m])
            if fast_fit is None:
                inner = _inner_tables(core, narrow_only=True)
                if inner is not None:
                    fast_fit = (inner, core, order[:m])
                    break
            if wide_fit is None and not require_fast:
                inner = _inner_tables(core, narrow_only=False)
                if inner is not None:
                    wide_fit = (inner, core, order[:m])
        fit = fast_fit or wide_fit
        if fit is None:
            raise ValueError("no fast core tier fits the sampled "
                             "hot set (visited %d states)" % V)
        self.inner, self.core, hot = fit
        self.hot2full = np.asarray(hot, dtype=np.int64)
        self.full2core = {sid: i for i, sid in enumerate(hot)}
        self.H = len(hot)
        self.esc_premult = self.H * self.inner.ncls
        self.last_repair = None

    def _build(self, hot):
        lazy = self.lazy
        H = len(hot)
        ncls = lazy.nclasses
        f2c = {sid: i for i, sid in enumerate(hot)}
        ct = np.full((H, ncls), H, np.int32)
        m = np.zeros((H, ncls), dtype=bool)
        eof = np.zeros(H, dtype=bool)
        for i, sid in enumerate(hot):
            eof[i] = lazy.match_eof(sid)
            for c in range(ncls):
                ns, mid = lazy._step(sid, c)
                ct[i, c] = f2c.get(ns, H)
                m[i, c] = mid >= 0
        from ..dfa import core_from_rows
        return core_from_rows(lazy.program, lazy.class_map, ct, m, eof)

    def to_core_premult(self, full_state):
        c = self.full2core.get(int(full_state), self.H)
        if c >= self.H:
            return -1
        return c * self.inner.ncls

    def to_full(self, core_premult):
        return int(self.hot2full[core_premult // self.inner.ncls])

    def to_full_vec(self, premult_arr):
        return self.hot2full[np.asarray(premult_arr) // self.inner.ncls]


class _Fold:
    """Vectorized repair fold over the per-chunk device planes.

    The scalar per-chunk trust walk is O(C) Python — ruinous once any
    chunk escapes (one escape at 10% of a 256 MB corpus left ~13k
    Python iterations on the table).  Instead, precompute the chain
    links once with numpy and resolve each maximal TRUSTED RUN
    [c..b] in O(1): a run starting at a chunk whose speculated entry
    (swarm) matches the chained entry extends while
    swarm[j+1] == phi[j] and chunk j+1 is clean (non-ESC, full-K,
    and fire-free when quiet=True).  Work is then O(#escapes), not
    O(#chunks)."""

    def __init__(self, ct, packed, C, K, n, quiet):
        self.ct = ct
        self.K = K
        self.n = n
        self.C = C
        self.phi, self.cnt, self.swarm = _unpack(packed, C)
        ok = self.phi != ct.esc_premult
        if C * K > n and (n - (C - 1) * K) != K:
            ok[C - 1] = False
        if quiet:
            ok &= self.cnt == 0
        self.ok = ok
        cont = np.zeros(C, dtype=bool)
        if C > 1:
            cont[:C - 1] = ok[1:] & (self.swarm[1:] == self.phi[:C - 1])
        # positions where a trusted run cannot extend past; C-1 is
        # always a break (cont[C-1] = False)
        self.breaks = np.flatnonzero(~cont)
        self.cum = np.cumsum(self.cnt.astype(np.int64))

    def run_end(self, c):
        """Last chunk b >= c of the maximal trusted run starting at a
        trusted chunk c."""
        i = np.searchsorted(self.breaks, c)
        return int(self.breaks[i])

    def trusted(self, c, e_full):
        """True when chunk c can be trusted entering in FULL state
        e_full (entry speculation matched, chunk clean)."""
        cp = self.ct.to_core_premult(e_full)
        return cp >= 0 and self.ok[c] and int(self.swarm[c]) == cp

    def run_count(self, c, b):
        """Sum of device fire counts over chunks [c..b]."""
        lo = self.cum[c - 1] if c else 0
        return int(self.cum[b] - lo)


def _run(ct, data_np, chunk_len, entry_state, prepared, COUNT,
         mesh=None, axis="data"):
    """Shared kernel dispatch: returns (summ int64[10], packed, raw,
    C, K, n) with the ESC check applied on device.  ``mesh`` shards
    the scan over devices exactly like the spec entry points (the
    per-chunk planes come back in global chunk order, so the host
    fold is mesh-agnostic)."""
    import jax
    from .prep import prepare_auto
    inner = ct.inner
    n = len(data_np)
    W = inner.warmup
    if prepared is None:
        prepared = prepare_auto(inner, data_np, chunk_len,
                                b_multiple=(mesh.devices.size
                                            if mesh is not None else 1))
    data, C, K, J, B = prepared
    ep = ct.to_core_premult(entry_state)
    assert ep >= 0, "entry state must be in the core (caller checks)"
    s0p, j0p = _entry_planes(jnp.int32(ep), jnp.int32(W), B=B)
    bad_tail = (C - 1) if C * K > n and (n - (C - 1) * K) != K else -1
    summary, packed = inner._scan(
        data if isinstance(data, jax.Array) else jnp.asarray(data),
        s0p, j0p, jnp.int32(C), jnp.int32(bad_tail), J, W,
        COUNT=COUNT, esc=ct.esc_premult, mesh=mesh,
        axis=axis if mesh is not None else None)
    summ = np.asarray(summary).astype(np.int64)
    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    ct.last_repair = None   # set by completed scans: (native chunks, C)
    return summ, packed, raw, C, K, n


def core_scan_bytes(ct, data_np, chunk_len=DEFAULT_K, entry_state=0,
                    prepared=None, mesh=None, axis="data"):
    """Whole-buffer first-match scan on the core tier.  Contract of
    spec_scan_bytes: returns (final FULL state, first match boundary
    or -1); on a match the state is the full state AT the boundary
    (regex id = ct.dfa.id_at(state, data[boundary])).  Exact: escaped
    or fired or speculation-missed chunks re-scan natively on the
    FULL machine."""
    n = len(data_np)
    if n == 0:
        return entry_state, -1
    summ, packed, raw, C, K, n = _run(ct, data_np, chunk_len,
                                      entry_state, prepared, False,
                                      mesh=mesh, axis=axis)
    if bool(summ[0]):
        # every chunk validated: no fires, no escapes, chain exact
        ct.last_repair = (0, C)
        return ct.to_full(int(summ[6])), -1
    fold = _Fold(ct, packed, C, K, n, quiet=True)
    native = ct.native
    e_full = ct.to_full(int(summ[2]))   # entries[fb]: validated, !ESC
    c = int(summ[1])
    nat = 0
    while c < C:
        if fold.trusted(c, e_full):
            b = fold.run_end(c)     # fire-free trusted run [c..b]
            e_full = ct.to_full(int(fold.phi[b]))
            c = b + 1
            continue
        lo = c * K
        hi = min(lo + K, n)
        f, st = native.scan_first(raw[lo:hi].tobytes(), e_full)
        if f >= 0:
            return st, lo + f
        e_full = st
        c += 1
        nat += 1
    ct.last_repair = (nat, C)
    return e_full, -1


def core_scan_last_bytes(ct, data_np, chunk_len=DEFAULT_K,
                         entry_state=0, prepared=None,
                         mesh=None, axis="data"):
    """Find the LAST boundary (0..n-1) at which a match ends, on the
    core tier.  Contract of spec_scan_last_bytes with FULL states
    (the reverse-scan start locator's primitive).  The exact position
    inside the last firing chunk is always pinned by a native
    FULL-machine re-scan of that one chunk, so the core's degraded
    match bits never leak into the answer."""
    n = len(data_np)
    if n == 0:
        return entry_state, -1
    summ, packed, raw, C, K, n = _run(ct, data_np, chunk_len,
                                      entry_state, prepared, True,
                                      mesh=mesh, axis=axis)
    native = ct.native
    if bool(summ[0]):
        ct.last_repair = (0, C)
        last_fire = int(summ[8])
        final = ct.to_full(int(summ[6]))
        if last_fire < 0:
            return final, -1
        lo = last_fire * K
        r, _ = native.scan_last(raw[lo:lo + K].tobytes(),
                                ct.to_full(int(summ[9])))
        return final, lo + r
    # repair: the device summary's last fire covers the validated
    # prefix; fold the rest in trusted runs.  Only the LAST firing
    # chunk overall ever needs a native position pin, so track it
    # lazily: ("pin", chunk, entry) for a trusted firing chunk,
    # ("pos", abs) for a natively scanned one — chunks are processed
    # in increasing order, so the latest record wins.
    last = None
    if int(summ[8]) >= 0:
        last = ("pin", int(summ[8]), ct.to_full(int(summ[9])))
    fold = _Fold(ct, packed, C, K, n, quiet=False)
    native = ct.native
    e_full = ct.to_full(int(summ[2]))
    c = int(summ[1])
    nat = 0
    while c < C:
        if fold.trusted(c, e_full):
            b = fold.run_end(c)
            if fold.run_count(c, b):
                js = np.flatnonzero(fold.cnt[c:b + 1])
                j = c + int(js[-1])
                last = ("pin", j, ct.to_full(int(fold.swarm[j])))
            e_full = ct.to_full(int(fold.phi[b]))
            c = b + 1
            continue
        lo = c * K
        hi = min(lo + K, n)
        r, st = native.scan_last(raw[lo:hi].tobytes(), e_full)
        if r >= 0:
            last = ("pos", lo + r)
        e_full = st
        c += 1
        nat += 1
    ct.last_repair = (nat, C)
    if last is None:
        return e_full, -1
    if last[0] == "pos":
        return e_full, last[1]
    _, j, ej = last
    lo = j * K
    r, _ = native.scan_last(raw[lo:min(lo + K, n)].tobytes(), ej)
    return e_full, lo + r


def core_chunk_map(ct, data_np, chunk_len=DEFAULT_K, entry_state=0,
                   prepared=None, mesh=None, axis="data"):
    """Validated per-chunk scan map on the core tier: (entries [C]
    FULL plain states, counts [C], final FULL state), all exact.
    Contract of spec_chunk_map — the finditer start locator's
    building block.  Escaped or speculation-missed chunks are
    re-counted natively on the FULL machine."""
    n = len(data_np)
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                entry_state)
    summ, packed, raw, C, K, n = _run(ct, data_np, chunk_len,
                                      entry_state, prepared, True,
                                      mesh=mesh, axis=axis)
    fold = _Fold(ct, packed, C, K, n, quiet=False)
    entries = np.zeros(C, dtype=np.int64)
    counts = fold.cnt.astype(np.int64).copy()
    native = ct.native
    fb = C if bool(summ[0]) else int(summ[1])
    if fb > 0:
        # validated prefix: every chunk's entry is its (validated)
        # speculation, so the whole prefix maps in one vector op
        entries[:fb] = ct.to_full_vec(fold.swarm[:fb])
        entries[0] = entry_state
        e_full = ct.to_full(int(fold.phi[fb - 1]))
    else:
        e_full = entry_state
    c = fb
    nat = 0
    while c < C:
        if fold.trusted(c, e_full):
            b = fold.run_end(c)
            entries[c:b + 1] = ct.to_full_vec(fold.swarm[c:b + 1])
            entries[c] = e_full
            e_full = ct.to_full(int(fold.phi[b]))
            c = b + 1
            continue
        lo = c * K
        hi = min(lo + K, n)
        entries[c] = e_full
        k, st = native.count(raw[lo:hi].tobytes(), e_full)
        counts[c] = k
        e_full = st
        c += 1
        nat += 1
    ct.last_repair = (nat, C)
    return entries, counts, e_full


def core_count_bytes(ct, data_np, chunk_len=DEFAULT_K, entry_state=0,
                     prepared=None, mesh=None, axis="data"):
    """Count match-ending boundaries (0..n-1; EOF is the caller's) on
    the core tier.  Contract of spec_count_bytes with FULL states."""
    n = len(data_np)
    if n == 0:
        return entry_state, 0
    summ, packed, raw, C, K, n = _run(ct, data_np, chunk_len,
                                      entry_state, prepared, True,
                                      mesh=mesh, axis=axis)
    if bool(summ[0]):
        ct.last_repair = (0, C)
        if n < 2 ** 31:
            return ct.to_full(int(summ[6])), int(summ[7])
        _, cnt, _ = _unpack(packed, C)
        return (ct.to_full(int(summ[6])),
                int(np.sum(cnt, dtype=np.int64)))
    fold = _Fold(ct, packed, C, K, n, quiet=False)
    native = ct.native
    total = int(summ[7])                # validated-prefix count
    e_full = ct.to_full(int(summ[2]))
    c = int(summ[1])
    nat = 0
    while c < C:
        if fold.trusted(c, e_full):
            b = fold.run_end(c)
            total += fold.run_count(c, b)
            e_full = ct.to_full(int(fold.phi[b]))
            c = b + 1
            continue
        lo = c * K
        hi = min(lo + K, n)
        k, st = native.count(raw[lo:hi].tobytes(), e_full)
        total += k
        e_full = st
        c += 1
        nat += 1
    ct.last_repair = (nat, C)
    return e_full, total


# ---------------------------------------------------------------------
# Fused two-phase count: core kernel + ON-DEVICE escape compaction +
# full-machine redo of escaped chunks + merged validation, all inside
# ONE jit (one dispatch RTT).
#
# Motivation: on the 90-keyword machine the legacy fold's plane
# readback and per-chunk ctypes repairs cost far more than the core
# walk itself.  Here escaped chunks never reach the host: their windows are gathered
# on device and re-scanned by the FULL machine's kernel (speculative
# warmup + swarm validation, the standard discipline), the per-chunk
# planes are merged in FULL premultiplied state space, and the common
# case reads back one ~11-int summary (all_ok), zero plane pulls,
# zero native repairs.
# ---------------------------------------------------------------------

# max escaped chunks the device redo absorbs per scan (rounded up at
# dispatch to a whole phase-2 block = GROUPS*1024 chunk slots); more
# overflow to the legacy host fold.  32768 covers a ~3% escape rate
# at 2 GiB / K=2048; phase-2 blocks
# holding no real escapes are gated off on device, so unused
# capacity costs only the window gather's bandwidth
FUSED_CAP = int(os.environ.get("SREGEX_FUSED_CAP", str(32768)))

# sampled visit mass allowed outside a FUSED-path core (per byte):
# escapes there cost a device redo (~K bytes through the full
# machine's kernel, compacted), not a native host walk, so the
# break-even escape rate is orders of magnitude higher than
# MAX_ESCAPE_FRAC — and admitting it lets the candidate search drop
# rare states (sampled keyword plants) for a much smaller, much
# faster core machine
FUSED_ESCAPE_FRAC = float(os.environ.get("SREGEX_FUSED_ESCAPE",
                                         "1e-3"))


def _tier_statics(tables):
    """(W, CPW, BITS) walk statics of a flat-table tier."""
    return tables.warmup, tables.cpw, tables.bits


def _fused_phases(core_data, full_data, s01, j01, core_fused,
                  full_fused, hot2full, live, *,
                  K, W1, CPW1, BITS1, W2, CPW2, BITS2,
                  CAP, NCLS_C, NCLS_F, ESC, IMPL,
                  p2_j0=None):
    """The two walk phases + on-device escape compaction + merge
    over ONE device's blocks (called directly single-chip, or inside
    the shard_map body of the mesh path — all index arithmetic here
    is block-local).  Returns (phi_m, fm_m, swarm_m) merged planes in
    FULL premult space, the phase-1 core planes, n_esc and the
    overflow flag.  ``live`` masks the chunk slots that carry real
    corpus chunks (the caller computes it from the GLOBAL chunk
    index, so mesh shards mask correctly).

    ``p2_j0``: optional int32 [Cp] per-chunk phase-2 j0 (gathered
    through the escape compaction) — the batched-document path
    freezes the redo warmup (j0 = W2) at document-start chunks, whose
    physical warmup window holds the PREVIOUS document's tail; all
    other chunks speculate from the seed at j0 = 0 as usual."""
    G = GROUPS
    B1 = core_data.shape[0]
    Cp = B1 * G * 8 * 128

    # ---- phase 1: core machine walk ----
    phi1, fm1, swarm1 = walk(core_data, s01, j01, core_fused, W=W1,
                             CPW=CPW1, BITS=BITS1, COUNT=True,
                             impl=IMPL)
    phi1 = phi1.reshape(Cp)
    fm1 = fm1.reshape(Cp)
    swarm1 = swarm1.reshape(Cp)

    idx = jnp.arange(Cp, dtype=jnp.int32)
    escaped = (phi1 == ESC) & live
    n_esc = jnp.sum(escaped.astype(jnp.int32))
    overflow = n_esc > CAP

    # ---- map core premult -> full premult (ESC -> -1) ----
    def to_full(x):
        m = jnp.take(hot2full, x // NCLS_C, mode="clip") * NCLS_F
        return jnp.where(x == ESC, jnp.int32(-1), m)

    phi_m = to_full(phi1)
    swarm_m = to_full(swarm1)
    fm_m = fm1

    # ---- compact escaped chunk indices (ascending) ----
    big = jnp.int32(1 << 30)
    key = jnp.where(escaped, idx, big)
    sel = jnp.sort(key)[:CAP]
    valid = sel < big
    # gather-safe padding (index 0) vs scatter padding (out-of-range
    # Cp + mode="drop"): padding slots must NEVER collide with a real
    # chunk slot in the merge scatter — duplicate-index scatter order
    # is undefined, and index-0 padding used to clobber a chunk-0
    # phase-2 redo with the stale pre-scatter value
    sel_g = jnp.where(valid, sel, 0)
    sel_s = jnp.where(valid, sel, jnp.int32(Cp))

    # ---- gather FULL-machine windows for the selected chunks ----
    B2 = CAP // (G * 1024)
    Jw2 = full_data.shape[1]
    b = sel_g // (G * 1024)
    rem = sel_g % (G * 1024)
    g = rem // 1024
    t = rem % 1024
    s = t // 128
    lane = t % 128
    rowsv = full_data[b, :, g, s, lane]          # [CAP, Jw2]
    blk = rowsv.reshape(B2, G, 8, 128, Jw2)
    blk = jnp.transpose(blk, (0, 4, 1, 2, 3))    # [B2, Jw2, G, 8, 128]

    # ---- phase 2: full-machine walk over the compacted block ----
    z2 = jnp.zeros((B2, G, 8, 128), jnp.int32)
    j02 = z2 if p2_j0 is None \
        else p2_j0[sel_g].reshape(B2, G, 8, 128)
    # escapes compact into a PREFIX of the CAP slots, so whole blocks
    # past ceil(n_esc / blockslots) carry only padding — gate them off
    blkslots = G * 1024
    nblk = (n_esc + blkslots - 1) // blkslots
    flags = (jnp.arange(B2, dtype=jnp.int32)
             < nblk).astype(jnp.int32)
    phi2, fm2, swarm2 = walk(blk, z2, j02, full_fused, flags, W=W2,
                             CPW=CPW2, BITS=BITS2, COUNT=True,
                             impl=IMPL)
    phi2 = phi2.reshape(CAP)
    fm2 = fm2.reshape(CAP)
    swarm2 = swarm2.reshape(CAP)

    # ---- merge (scatter phase-2 results over the escaped slots;
    # padding rides out-of-range indices and is dropped) ----
    phi_m = phi_m.at[sel_s].set(phi2, mode="drop")
    fm_m = fm_m.at[sel_s].set(fm2, mode="drop")
    swarm_m = swarm_m.at[sel_s].set(swarm2, mode="drop")
    return (phi_m, fm_m, swarm_m, phi1, fm1, swarm1, n_esc, overflow)


@functools.partial(jax.jit, static_argnames=(
    "K", "W1", "CPW1", "BITS1", "W2", "CPW2", "BITS2",
    "CAP", "NCLS_C", "NCLS_F", "ESC", "IMPL"))
def _fused_count(core_data, full_data, core_fused, full_fused,
                 hot2full, C, entry_core, entry_full, *,
                 K, W1, CPW1, BITS1, W2, CPW2, BITS2,
                 CAP, NCLS_C, NCLS_F, ESC, IMPL):
    """Returns (summary int32[11], merged int32 [3, Cp] in FULL
    premult space, core packed int32 [3, Cp] in core space).

    summary: [0] all_ok (merged chain valid, no overflow)
             [1] fb  [2] entry@fb  [3] swarm@fb  [4] phi@fb
             [5] phi@C-1  [6] prefix count (sum fm[0:fb])
             [7] overflow (escaped > CAP)  [8] n_escaped
             [9] first firing chunk in the validated prefix (-1)
             [10] entry @ that chunk."""
    G = GROUPS
    B1 = core_data.shape[0]
    Cp = B1 * G * 8 * 128
    idx = jnp.arange(Cp, dtype=jnp.int32)
    live = idx < C
    s01, j01 = _entry_planes(entry_core, jnp.int32(W1), B=B1)
    (phi_m, fm_m, swarm_m, phi1, fm1, swarm1, n_esc,
     overflow) = _fused_phases(
        core_data, full_data, s01, j01, core_fused, full_fused,
        hot2full, live,
        K=K, W1=W1, CPW1=CPW1, BITS1=BITS1, W2=W2, CPW2=CPW2,
        BITS2=BITS2, CAP=CAP, NCLS_C=NCLS_C, NCLS_F=NCLS_F, ESC=ESC,
        IMPL=IMPL)

    # ---- merged validation chain (FULL premult space) ----
    entries = jnp.concatenate([entry_full[None], phi_m[:-1]])
    okv = (swarm_m == entries) | ~live
    all_ok = jnp.all(okv) & ~overflow
    fb = jnp.argmin(okv.astype(jnp.int32)).astype(jnp.int32)
    fb_eff = jnp.where(jnp.all(okv), C, fb)
    prefix = jnp.sum(jnp.where((idx < fb_eff) & live, fm_m, 0))
    # first firing chunk in the validated prefix + its exact entry
    # (first-match scans pin the boundary with one native chunk scan)
    firev = (fm_m > 0) & (idx < fb_eff) & live
    any_fire = jnp.any(firev)
    ff = jnp.where(any_fire,
                   jnp.argmax(firev.astype(jnp.int32)), 0)
    first_fire = jnp.where(any_fire, ff, -1).astype(jnp.int32)
    summary = jnp.stack([
        all_ok.astype(jnp.int32), fb, entries[fb], swarm_m[fb],
        phi_m[fb], phi_m[C - 1], prefix.astype(jnp.int32),
        overflow.astype(jnp.int32), n_esc,
        first_fire, entries[ff]])
    merged = jnp.stack([phi_m, fm_m, swarm_m])
    packed_core = jnp.stack([phi1, fm1, swarm1])
    return summary, merged, packed_core


@functools.partial(jax.jit, static_argnames=(
    "K", "W1", "CPW1", "BITS1", "W2", "CPW2", "BITS2",
    "CAP", "NCLS_C", "NCLS_F", "ESC", "IMPL", "NDOCS"))
def _fused_batch(core_data, full_data, s01, j01, p2_j0, core_fused,
                 full_fused, hot2full, C, doc_id, fullv, doc_startv,
                 last_full, *,
                 K, W1, CPW1, BITS1, W2, CPW2, BITS2,
                 CAP, NCLS_C, NCLS_F, ESC, IMPL, NDOCS):
    """Fused two-phase dispatch for the BATCHED document stream
    (ops/batch.py): both kernel phases + on-device escape redo + the
    PER-DOCUMENT validation fold in one jit.

    The per-chunk planes over a big document set are megabytes, so
    the common case must not read them back.  Document chains validate on device: a full
    chunk is ok when its speculated entry equals its predecessor's
    exit (document starts restart at the seed), all_ok means every
    full chunk of every document validated (chain induction per doc),
    per-document counts segment-sum over doc_id, and each document's
    final full-region exit gathers at last_full.  Ragged tails always
    finish on host from those exits.

    s01/j01: phase-1 entry planes (seed at every document start,
    j0 = W1 frozen — ops/batch._batch_entry_planes).  p2_j0: int32
    [Cp] phase-2 j0 per chunk (W2 at document starts).  doc_id [Cp]
    (padding = NDOCS, dropped), fullv/doc_startv [Cp] 0/1, last_full
    [NDOCS] (clipped index of each doc's last FULL chunk; docs
    without one are masked on host).

    Returns (summary int32 [2 + 2*NDOCS] = [all_ok, n_esc | counts |
    finals], merged [3, Cp] FULL premult, packed core planes
    [3, Cp], flags [n_esc, overflow]) — read ONLY the summary unless
    all_ok is 0."""
    Cp = core_data.shape[0] * GROUPS * 8 * 128
    idx = jnp.arange(Cp, dtype=jnp.int32)
    live = idx < C
    (phi_m, fm_m, swarm_m, phi1, fm1, swarm1, n_esc,
     overflow) = _fused_phases(
        core_data, full_data, s01, j01, core_fused, full_fused,
        hot2full, live,
        K=K, W1=W1, CPW1=CPW1, BITS1=BITS1, W2=W2, CPW2=CPW2,
        BITS2=BITS2, CAP=CAP, NCLS_C=NCLS_C, NCLS_F=NCLS_F, ESC=ESC,
        IMPL=IMPL,
        p2_j0=p2_j0)
    # per-document chain validation (document starts take the seed)
    entries = jnp.where(doc_startv == 1, jnp.int32(0),
                        jnp.concatenate([jnp.zeros(1, jnp.int32),
                                         phi_m[:-1]]))
    okv = (swarm_m == entries) & (fullv == 1)
    all_ok = jnp.all(okv | (fullv == 0)) & ~overflow
    dcounts = jnp.zeros(NDOCS, jnp.int32).at[doc_id].add(
        jnp.where(okv, fm_m, 0), mode="drop")
    dfinals = phi_m[jnp.clip(last_full, 0, Cp - 1)]
    summary = jnp.concatenate([
        jnp.stack([all_ok.astype(jnp.int32), n_esc]),
        dcounts, dfinals])
    merged = jnp.stack([phi_m, fm_m, swarm_m])
    packed = jnp.stack([phi1, fm1, swarm1])
    flags = jnp.stack([n_esc, overflow.astype(jnp.int32)])
    return summary, merged, packed, flags


@functools.partial(jax.jit, static_argnames=(
    "K", "W1", "CPW1", "BITS1", "W2", "CPW2", "BITS2",
    "CAP", "NCLS_C", "NCLS_F", "ESC", "IMPL", "mesh", "axis"))
def _fused_count_mesh(core_data, full_data, core_fused, full_fused,
                      hot2full, C, entry_core, entry_full, *,
                      K, W1, CPW1, BITS1, W2, CPW2, BITS2,
                      CAP, NCLS_C, NCLS_F, ESC, IMPL, mesh, axis):
    """Mesh variant of _fused_count (VERDICT r4 #3): the whole
    two-phase dispatch shard_maps over the chunk-block dim.  Phase-1
    planes, the escape compaction, the phase-2 window gather (chunk
    slots are lane-ordered WITHIN a shard, so the gather never
    crosses shards) and the merge are all shard-local; the merged
    validation chain stitches shards with one ppermute of each
    shard's last exit (the same swarm==entries discipline that
    stitches chunks).  CAP is PER SHARD (aggregate capacity scales
    with the mesh).

    Returns (summaries int32 [ndev, 11] — per-shard partial
    summaries, combined on host by _combine_fused_summaries into the
    exact single-chip 11-summary — merged [3, Cp] and core packed
    [3, Cp] planes in GLOBAL chunk order)."""
    from jax import lax, shard_map
    from jax.sharding import PartitionSpec as P

    G = GROUPS
    ndev = mesh.shape[axis]
    B1g = core_data.shape[0]
    B1l = B1g // ndev
    Cp_l = B1l * G * 8 * 128
    s01, j01 = _entry_planes(entry_core, jnp.int32(W1), B=B1g)

    def body(cd, fd, s0, j0, cf, ffv, h2f, Cv, ef):
        shard = lax.axis_index(axis)
        base = (shard * Cp_l).astype(jnp.int32)
        idx = jnp.arange(Cp_l, dtype=jnp.int32)
        live = (base + idx) < Cv
        (phi_m, fm_m, swarm_m, phi1, fm1, swarm1, n_esc,
         overflow) = _fused_phases(
            cd, fd, s0, j0, cf, ffv, h2f, live,
            K=K, W1=W1, CPW1=CPW1, BITS1=BITS1, W2=W2, CPW2=CPW2,
            BITS2=BITS2, CAP=CAP, NCLS_C=NCLS_C, NCLS_F=NCLS_F,
            ESC=ESC, IMPL=IMPL)
        # cross-shard stitch: the previous shard's last exit is this
        # shard's first entry (shard 0 takes the caller's entry)
        prev = lax.ppermute(phi_m[Cp_l - 1:], axis,
                            [(i, i + 1) for i in range(ndev - 1)])
        first_entry = jnp.where(shard == 0, ef, prev[0])
        entries = jnp.concatenate([first_entry[None], phi_m[:-1]])
        okv = (swarm_m == entries) | ~live
        all_ok_l = jnp.all(okv) & ~overflow
        fbl = jnp.argmin(okv.astype(jnp.int32)).astype(jnp.int32)
        fb_eff = jnp.where(jnp.all(okv), Cp_l, fbl)
        prefix = jnp.sum(jnp.where((idx < fb_eff) & live, fm_m, 0))
        firev = (fm_m > 0) & (idx < fb_eff) & live
        any_fire = jnp.any(firev)
        ffl = jnp.where(any_fire,
                        jnp.argmax(firev.astype(jnp.int32)), 0)
        first_fire = jnp.where(any_fire, base + ffl,
                               -1).astype(jnp.int32)
        # this shard's slot of chunk C-1 (only the owner's is read)
        last_i = jnp.clip(Cv - 1 - base, 0, Cp_l - 1)
        summary = jnp.stack([
            all_ok_l.astype(jnp.int32), base + fbl, entries[fbl],
            swarm_m[fbl], phi_m[fbl], phi_m[last_i],
            prefix.astype(jnp.int32), overflow.astype(jnp.int32),
            n_esc, first_fire, entries[ffl]])
        merged = jnp.stack([phi_m, fm_m, swarm_m])
        packed = jnp.stack([phi1, fm1, swarm1])
        return summary[None], merged, packed

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis),
                  P(), P(), P(), P(), P()),
        out_specs=(P(axis, None), P(None, axis), P(None, axis)),
        check_vma=False,
    )(core_data, full_data, s01, j01, core_fused, full_fused,
      hot2full, C, entry_full)


def _combine_fused_summaries(S, C, Cp_l):
    """Host fold of the per-shard partial summaries into the exact
    single-chip 11-summary contract (the repair walks downstream are
    mesh-agnostic).  The global chain validates iff every shard's
    local chain (including its ppermute stitch) validates; the first
    break is the first breaking shard's, the validated-prefix count
    sums whole shards before it plus its local prefix, and the first
    fire is the first firing shard's at or before it."""
    S = np.asarray(S).astype(np.int64)
    ndev = S.shape[0]
    owner = min((C - 1) // Cp_l, ndev - 1)
    phi_last = int(S[owner, 5])
    n_esc = int(S[:, 8].sum())
    overflow = int(bool(S[:, 7].any()))
    bad = np.flatnonzero(S[:, 0] == 0)
    if len(bad) == 0:
        all_ok, s_star = 1, ndev
        fb, e_fb, sw_fb, phi_fb = C, 0, 0, 0
        prefix = int(S[:, 6].sum())
    else:
        all_ok, s_star = 0, int(bad[0])
        fb = int(S[s_star, 1])
        e_fb = int(S[s_star, 2])
        sw_fb = int(S[s_star, 3])
        phi_fb = int(S[s_star, 4])
        prefix = int(S[:s_star, 6].sum() + S[s_star, 6])
    ff, e_ff = -1, 0
    for s in range(min(s_star + 1, ndev)):
        if S[s, 9] >= 0:
            ff, e_ff = int(S[s, 9]), int(S[s, 10])
            break
    return np.array([all_ok, fb, e_fb, sw_fb, phi_fb, phi_last,
                     prefix, overflow, n_esc, ff, e_ff],
                    dtype=np.int64)


def fused_chunk(inner, full_tables, chunk_len=DEFAULT_K):
    """Chunk length BOTH fused preps agree on, or None when no
    alignment exists.  The two tiers' packing quanta
    (cpw * WORDS_PER_ITER) can differ, and a warmup-escalated full
    machine (the W=2048 ladder threads into the phase-2 tables) can
    clamp its chunk harder than the core — iterate the mutual
    round-down to a fixed point."""
    from .pallas_scan import effective_chunk
    K1 = effective_chunk(inner, chunk_len)
    K2 = effective_chunk(full_tables, chunk_len)
    for _ in range(6):
        if K1 == K2:
            return K1
        k = min(K1, K2)
        K1 = effective_chunk(inner, k)
        K2 = effective_chunk(full_tables, k)
    return K1 if K1 == K2 else None


def _fused_dispatch(ct, full_tables, data_np, chunk_len,
                    entry_state, prepared_core, prepared_full,
                    mesh=None, axis="data"):
    """Shared setup + dispatch for the fused entry points.  Returns
    None when the shapes disqualify the fused path, else a dict with
    the summary, the (lazy) merged/core plane handles, and the
    chunking facts.  ``mesh`` shards the whole two-phase dispatch
    over devices (_fused_count_mesh); the per-shard summaries are
    folded back into the single-chip contract here, so the repair
    walks in the entry points stay mesh-agnostic."""
    from .pallas_scan import effective_chunk
    from .prep import prepare_auto

    from .pallas_big import SpecTablesBig
    inner = ct.inner
    if not isinstance(inner, (SpecTables, SpecTablesWide)) \
            or not isinstance(full_tables, (SpecTables,
                                            SpecTablesWide,
                                            SpecTablesBig)):
        return None
    if getattr(inner, "bpu", 1) != 1 \
            or getattr(full_tables, "bpu", 1) != 1:
        return None
    K1 = fused_chunk(inner, full_tables, chunk_len)
    if K1 is None:
        return None
    chunk_len = K1
    n = len(data_np)
    ep = ct.to_core_premult(entry_state)
    if ep < 0:
        return None

    ndev = mesh.shape[axis] if mesh is not None else 1
    if n and prepared_core is not None and \
            (prepared_core[2] != K1 or prepared_core[4] % ndev):
        prepared_core = None      # caller's prep predates K alignment
    if n and prepared_full is not None and \
            (prepared_full[2] != K1 or prepared_full[4] % ndev):
        prepared_full = None
    if n and prepared_core is None:
        prepared_core = prepare_auto(inner, data_np, chunk_len,
                                     b_multiple=ndev)
    if n and prepared_full is None:
        prepared_full = prepare_auto(full_tables, data_np, chunk_len,
                                     b_multiple=ndev)
    if n == 0:
        return {"summ": None, "C": 0, "Cfull": 0, "K": K1, "n": 0,
                "B1": 0, "merged": None, "packed_core": None}
    core_data, C, K, J1, B1 = prepared_core
    full_data, Cf, Kf, J2, Bf = prepared_full
    assert (C, K) == (Cf, Kf), "preps disagree on chunking"

    # full-chunk region only: the ragged tail (and EOF) finish on the
    # host from the composed exit, so the all_ok fast path stays
    # reachable for every corpus length
    Cfull = C - 1 if C * K > n and (n - (C - 1) * K) != K else C

    w1, c1, b1 = _tier_statics(inner)
    w2, c2, b2_ = _tier_statics(full_tables)
    # hot->full map: device-resident ONCE per CoreTables (no per-call
    # host->device put)
    h2f_dev = getattr(ct, "_h2f_dev", None)
    if h2f_dev is None:
        h2f = np.full(ct.H + 1, -1, dtype=np.int32)
        h2f[:ct.H] = np.asarray(ct.hot2full[:ct.H], dtype=np.int32)
        h2f_dev = jnp.asarray(h2f)
        ct._h2f_dev = h2f_dev
    # Cp = B1 * GROUPS * 1024 chunk slots; never allocate more phase-2
    # capacity than that, and ALWAYS round up to whole phase-2 blocks
    # (GROUPS*1024) — phase 2 reshapes to [B2, G, 8, 128] and a cap
    # below one block would trace B2 = 0 and decline the tier.
    # On a mesh the cap (like the compaction) is PER SHARD, so the
    # aggregate redo capacity scales with the device count.
    blk = GROUPS * 1024
    cap = min(FUSED_CAP, (B1 // ndev) * blk)
    cap = max(blk, -(-cap // blk) * blk)

    fv1, fv2 = inner.table, full_tables.table
    if Cfull <= 0:
        summ = merged = packed_core = None
    else:
        t_disp = time.perf_counter()
        # scalars ride np.int32 (shipped with the execute call, not
        # as separate device ops)
        statics = dict(
            K=K, W1=w1, CPW1=c1, BITS1=b1, W2=w2, CPW2=c2, BITS2=b2_,
            CAP=cap, NCLS_C=inner.ncls, NCLS_F=full_tables.ncls,
            ESC=ct.esc_premult, IMPL=implementation())
        args = (core_data if isinstance(core_data, jax.Array)
                else jnp.asarray(core_data),
                full_data if isinstance(full_data, jax.Array)
                else jnp.asarray(full_data),
                fv1, fv2, h2f_dev, np.int32(Cfull),
                np.int32(ep),
                np.int32(entry_state * full_tables.ncls))
        if mesh is None:
            summary, merged, packed_core = _fused_count(
                *args, **statics)
            t_read = time.perf_counter()
            summ = np.asarray(summary).astype(np.int64)
        else:
            summary, merged, packed_core = _fused_count_mesh(
                *args, mesh=mesh, axis=axis, **statics)
            t_read = time.perf_counter()
            summ = _combine_fused_summaries(
                summary, Cfull, (B1 // ndev) * GROUPS * 1024)
        # phase decomposition for bench/profile_driver.py: enqueue
        # (async jit dispatch) vs blocking summary readback
        ct.last_timing = {"enqueue_s": t_read - t_disp,
                          "readback_s": time.perf_counter() - t_read}
    return {"summ": summ, "C": C, "Cfull": Cfull, "K": K, "n": n,
            "B1": B1, "merged": merged, "packed_core": packed_core}


def core_count_fused(ct, full_tables, data_np, chunk_len=DEFAULT_K,
                     entry_state=0, prepared_core=None,
                     prepared_full=None, mesh=None, axis="data"):
    """Count match-ending boundaries (0..n-1; EOF is the caller's) via
    the fused two-phase path.  Contract of core_count_bytes.  Returns
    None when the shapes disqualify it (different K between the two
    preps, non-dense tiers) — the caller falls back to the legacy
    paths.  ``mesh`` shards the two-phase dispatch over devices."""
    d = _fused_dispatch(ct, full_tables, data_np, chunk_len,
                        entry_state, prepared_core, prepared_full,
                        mesh=mesh, axis=axis)
    if d is None:
        return None
    if d["n"] == 0:
        return entry_state, 0
    summ, Cfull, K, n, B1 = (d["summ"], d["Cfull"], d["K"], d["n"],
                             d["B1"])
    merged, packed_core = d["merged"], d["packed_core"]
    tail_lo = Cfull * K

    native = ct.native
    ncls_f = full_tables.ncls
    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    ct.last_repair = None
    # why the last fused scan repaired on host (None = it didn't):
    # "overflow" = more escapes than the device redo cap (a core-
    # quality problem — re-coring helps), "miss" = the phase-2 redo
    # failed to certify (the FULL machine's warmup did not converge
    # on the escape regions — warmup-ladder escalation helps)
    ct.last_fused_cause = None

    if summ is None:
        e_full, total = entry_state, 0
        ct.last_repair = (0, 0)
    elif bool(summ[0]):
        # merged chain validated end to end: zero host repairs
        ct.last_repair = (0, Cfull)
        e_full = int(summ[5]) // ncls_f
        if n >= 2 ** 31:
            # the device prefix is int32; re-sum the merged per-chunk
            # fire counts in int64 (mirrors core_count_bytes' guard)
            fm64 = np.asarray(merged)[1].astype(np.int64)
            total = int(fm64[:Cfull].sum())
        else:
            total = int(summ[6])
    elif bool(summ[7]):
        # overflow: more escapes than the device redo cap — legacy
        # host fold over the CORE-space planes
        ct.last_fused_cause = "overflow"
        fold = _Fold(ct, np.asarray(packed_core).reshape(
            3, B1, GROUPS, 8, 128), Cfull, K, min(n, Cfull * K),
            quiet=False)
        total = 0
        e_full = entry_state
        c = 0
        nat = 0
        while c < Cfull:
            if fold.trusted(c, e_full):
                b = fold.run_end(c)
                total += fold.run_count(c, b)
                e_full = ct.to_full(int(fold.phi[b]))
                c = b + 1
                continue
            lo = c * K
            k, st = native.count(raw[lo:lo + K].tobytes(), e_full)
            total += k
            e_full = st
            c += 1
            nat += 1
        ct.last_repair = (nat, Cfull)
    else:
        # residual speculation miss: walk the MERGED (full-space)
        # planes from the first break — rare, a few chunks
        ct.last_fused_cause = "miss"
        phi_m, fm_m, swarm_m = np.asarray(merged).astype(np.int64)
        c = int(summ[1])
        # int64 prefix when the int32 device sum could wrap
        total = int(fm_m[:c].sum()) if n >= 2 ** 31 else int(summ[6])
        e = int(summ[2])
        nat = 0
        while c < Cfull:
            if int(swarm_m[c]) == e and e >= 0:
                total += int(fm_m[c])
                e = int(phi_m[c])
                c += 1
                continue
            lo = c * K
            k, st = native.count(raw[lo:lo + K].tobytes(),
                                 max(e, 0) // ncls_f)
            total += k
            e = st * ncls_f
            c += 1
            nat += 1
        e_full = e // ncls_f
        ct.last_repair = (nat, Cfull)

    if tail_lo < n:
        k, e_full = native.count(raw[tail_lo:].tobytes(), e_full)
        total += k
    return e_full, total


def core_chunk_map_fused(ct, full_tables, data_np,
                         chunk_len=DEFAULT_K, entry_state=0,
                         prepared_core=None, prepared_full=None,
                         mesh=None, axis="data"):
    """Validated per-chunk scan map via the fused two-phase path:
    (entries [C] FULL plain states, counts [C], final FULL state),
    all exact — the contract of core_chunk_map (the finditer start
    locator's building block), with escaped chunks redone by the
    full machine's kernel ON DEVICE instead of one native host walk
    each.  Returns None when the shapes disqualify the fused path."""
    d = _fused_dispatch(ct, full_tables, data_np, chunk_len,
                        entry_state, prepared_core, prepared_full,
                        mesh=mesh, axis=axis)
    if d is None:
        return None
    if d["n"] == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                entry_state)
    summ, C, Cfull, K, n, B1 = (d["summ"], d["C"], d["Cfull"],
                                d["K"], d["n"], d["B1"])
    merged, packed_core = d["merged"], d["packed_core"]
    native = ct.native
    ncls_f = full_tables.ncls
    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    ct.last_repair = None
    ct.last_fused_cause = None
    entries = np.zeros(C, dtype=np.int64)
    counts = np.zeros(C, dtype=np.int64)

    if summ is not None and bool(summ[7]):
        # escape overflow: the legacy CORE-plane fold (identical to
        # core_chunk_map's repair discipline)
        ct.last_fused_cause = "overflow"
        fold = _Fold(ct, np.asarray(packed_core).reshape(
            3, B1, GROUPS, 8, 128), Cfull, K, min(n, Cfull * K),
            quiet=False)
        counts[:Cfull] = fold.cnt
        e_full = entry_state
        c = 0
        nat = 0
        while c < Cfull:
            if fold.trusted(c, e_full):
                b = fold.run_end(c)
                entries[c:b + 1] = ct.to_full_vec(fold.swarm[c:b + 1])
                entries[c] = e_full
                e_full = ct.to_full(int(fold.phi[b]))
                c = b + 1
                continue
            lo = c * K
            entries[c] = e_full
            k, st = native.count(raw[lo:lo + K].tobytes(), e_full)
            counts[c] = k
            e_full = st
            c += 1
            nat += 1
        ct.last_repair = (nat, Cfull)
    elif summ is not None:
        phi_m, fm_m, swarm_m = np.asarray(merged).astype(np.int64)
        counts[:Cfull] = fm_m[:Cfull]
        fb = Cfull if bool(summ[0]) else int(summ[1])
        if fb > 0:
            # validated prefix: every chunk's entry is its validated
            # speculation (FULL premult)
            entries[:fb] = swarm_m[:fb] // ncls_f
            entries[0] = entry_state
            e = int(phi_m[fb - 1])
        else:
            e = entry_state * ncls_f
        c = fb
        nat = 0
        while c < Cfull:
            if e >= 0 and int(swarm_m[c]) == e:
                entries[c] = e // ncls_f
                e = int(phi_m[c])
                c += 1
                continue
            if nat == 0:
                ct.last_fused_cause = "miss"
            lo = c * K
            entries[c] = max(e, 0) // ncls_f
            k, st = native.count(raw[lo:lo + K].tobytes(),
                                 max(e, 0) // ncls_f)
            counts[c] = k
            e = st * ncls_f
            c += 1
            nat += 1
        e_full = max(e, 0) // ncls_f
        ct.last_repair = (nat, Cfull)
    else:
        e_full = entry_state
        ct.last_repair = (0, 0)

    # ragged tail chunk (and any chunk past Cfull): native
    for c in range(Cfull, C):
        lo = c * K
        hi = min(lo + K, n)
        entries[c] = e_full
        k, st = native.count(raw[lo:hi].tobytes(), e_full)
        counts[c] = k
        e_full = st
    return entries, counts, e_full


def core_scan_fused(ct, full_tables, data_np, chunk_len=DEFAULT_K,
                    entry_state=0, prepared_core=None,
                    prepared_full=None, mesh=None, axis="data"):
    """First-match scan via the fused two-phase path.  Contract of
    core_scan_bytes / spec_scan_bytes: returns (state, boundary or
    -1) with the state AT the boundary on a match (boundaries
    0..n-1; EOF acceptance is the caller's).  Returns None when the
    shapes disqualify the fused path; the first firing chunk's exact
    position is pinned with ONE native full-machine chunk scan from
    its validated entry."""
    d = _fused_dispatch(ct, full_tables, data_np, chunk_len,
                        entry_state, prepared_core, prepared_full,
                        mesh=mesh, axis=axis)
    if d is None:
        return None
    if d["n"] == 0:
        return entry_state, -1
    summ, Cfull, K, n, B1 = (d["summ"], d["Cfull"], d["K"], d["n"],
                             d["B1"])
    merged, packed_core = d["merged"], d["packed_core"]
    tail_lo = Cfull * K
    native = ct.native
    ncls_f = full_tables.ncls
    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    ct.last_repair = None
    ct.last_fused_cause = None     # see core_count_fused

    e_full = entry_state
    if summ is not None:
        ff = int(summ[9])
        if ff >= 0:
            # first firing chunk in the validated prefix: its entry
            # (summ[10], full premult) is exact by the chain argument
            lo = ff * K
            f, st = native.scan_first(raw[lo:lo + K].tobytes(),
                                      int(summ[10]) // ncls_f)
            return st, lo + f
        if bool(summ[0]):
            ct.last_repair = (0, Cfull)
            e_full = int(summ[5]) // ncls_f
        elif bool(summ[7]):
            # overflow: legacy CORE-plane fold (quiet: any fired or
            # escaped chunk re-scans natively and may return a match)
            ct.last_fused_cause = "overflow"
            fold = _Fold(ct, np.asarray(packed_core).reshape(
                3, B1, GROUPS, 8, 128), Cfull, K, min(n, Cfull * K),
                quiet=True)
            e_full = entry_state
            c = 0
            nat = 0
            while c < Cfull:
                if fold.trusted(c, e_full):
                    b = fold.run_end(c)
                    e_full = ct.to_full(int(fold.phi[b]))
                    c = b + 1
                    continue
                lo = c * K
                f, st = native.scan_first(raw[lo:lo + K].tobytes(),
                                          e_full)
                if f >= 0:
                    return st, lo + f
                e_full = st
                c += 1
                nat += 1
            ct.last_repair = (nat, Cfull)
        else:
            # chain broke before any fire: walk the merged planes
            ct.last_fused_cause = "miss"
            phi_m, fm_m, swarm_m = np.asarray(merged).astype(np.int64)
            e = int(summ[2])
            c = int(summ[1])
            nat = 0
            while c < Cfull:
                if int(swarm_m[c]) == e and e >= 0 \
                        and int(fm_m[c]) == 0:
                    e = int(phi_m[c])
                    c += 1
                    continue
                lo = c * K
                f, st = native.scan_first(raw[lo:lo + K].tobytes(),
                                          max(e, 0) // ncls_f)
                if f >= 0:
                    return st, lo + f
                e = st * ncls_f
                c += 1
                nat += 1
            e_full = e // ncls_f
            ct.last_repair = (nat, Cfull)

    if tail_lo < n:
        f, st = native.scan_first(raw[tail_lo:].tobytes(), e_full)
        if f >= 0:
            return st, tail_lo + f
        e_full = st
    return e_full, -1
