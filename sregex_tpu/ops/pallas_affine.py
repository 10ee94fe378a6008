"""Piecewise-affine speculative scan: counted-repetition monsters at
near-narrow speed, independent of state count.

The big-table tier exists because counted repetitions explode the
state space (`a{400,499}b` -> 402 states; the conformance corpus'
largest machine is 57,816 entries), and a general S*ncls-entry table
forces O(rows) gather+select work per byte (ops/pallas_big.py).  But
those machines are COUNTING CHAINS: probed on real DFAs, their
transition function is piecewise affine in the state id —

    next(s, c) = s + d[p, c]   (relative: the chain advances)
              or   t[p, c]     (absolute: reset / dead / accept hop)

with p the piece containing s, and 3-6 pieces covering hundreds of
states (`a{400,499}b` -> 3, `a{499}b{499}c{499}` -> 5 pieces for
1,498 states).  The kernel therefore needs only

    pid   = sum of P-1 vector compares against static breakpoints,
    entry = one small-table gather ([P * ncls] <= a few rows),
    next  = select(mode, state + delta, absolute)

— ~P + 4 vector ops per byte, for ANY chain length.  Detection is
exact by construction: a piece extends only while every class keeps a
consistent relative-or-absolute representation (and match bits agree),
so the rebuilt table IS the transition function; machines that are not
piecewise affine (P too large) simply decline to the wide/big tiers.

Everything else — 4/8-bit class packing, chunk speculation, swarm
validation, native repair, _summarize, the spec_* drivers — is reused
unchanged; this is just another tables class with its own byte step
for the plain chunk walk (ops/scan_kernel.walk_plain_step).

Replaces the reference JIT's per-thread bytecode dispatch for the
counted-rep class (sre_vm_thompson_x64.dasc:738-889) with work that
does not grow with the automaton.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .pallas_scan import _summarize, max_chunk_bytes
from .scan_kernel import walk_plain_step

_VAL_MASK = (1 << 27) - 1     # |delta*ncls + OFF| or absolute premult
_MODE_BIT = 28                # 1 = relative (state + delta)
_MATCH_BIT = 30
MAX_PIECES = 48               # lookup table stays small
MAX_ENTRIES = 1 << 26         # S * ncls cap (premult fits the mask)


def detect_pieces(dfa):
    """Greedy exact piecewise-affine factorization.  Returns
    (bounds list [P], mode [P, ncls] bool, val [P, ncls] int64,
    match [P, ncls]) or raises ValueError when P > MAX_PIECES.

    Piece p covers states bounds[p] .. bounds[p+1]-1; for class c:
    mode=True: next = s + val (val = common delta), else next = val
    (common absolute target).  Exact by construction: a piece only
    extends while one representation stays consistent for EVERY
    class and the match bits agree."""
    S, ncls = dfa.nstates, dfa.nclasses
    if S * ncls > MAX_ENTRIES:
        raise ValueError("automaton exceeds the affine premult mask")
    t = dfa.trans.astype(np.int64)
    m = dfa.match.astype(np.int64)
    bounds = [0]
    abs_ok = np.ones(ncls, bool)
    rel_ok = np.ones(ncls, bool)
    for s in range(1, S):
        a_ok = abs_ok & (t[s] == t[s - 1]) & (m[s] == m[s - 1])
        r_ok = rel_ok & (t[s] - s == t[s - 1] - (s - 1)) \
            & (m[s] == m[s - 1])
        if np.all(a_ok | r_ok):
            abs_ok, rel_ok = a_ok, r_ok
        else:
            bounds.append(s)
            abs_ok = np.ones(ncls, bool)
            rel_ok = np.ones(ncls, bool)
        if len(bounds) > MAX_PIECES:
            raise ValueError("not piecewise affine (P > %d)"
                             % MAX_PIECES)
    P = len(bounds)
    mode = np.zeros((P, ncls), bool)
    val = np.zeros((P, ncls), np.int64)
    match = np.zeros((P, ncls), np.int64)
    ext = bounds + [S]
    for p in range(P):
        lo, hi = ext[p], ext[p + 1]
        match[p] = m[lo]
        for c in range(ncls):
            if hi - lo == 1 or np.all(t[lo:hi, c] == t[lo, c]):
                mode[p, c] = False          # absolute
                val[p, c] = t[lo, c]
            else:
                mode[p, c] = True           # relative
                val[p, c] = t[lo, c] - lo
    # verification (cheap, proves the representation exact)
    s_ids = np.arange(S)
    pid = np.searchsorted(np.asarray(bounds), s_ids, side="right") - 1
    rebuilt = np.where(mode[pid], s_ids[:, None] + val[pid], val[pid])
    if not (np.array_equal(rebuilt, t)
            and np.array_equal(match[pid], m)):
        raise ValueError("affine verification failed")  # never
    return bounds, mode, val, match


def periodic_perm(dfa, max_w=64, max_extra=96):
    """Residue-major renumbering for PRODUCT chains.

    Branching counted repetitions ((?:ab?c){200,480}-style) interleave
    W substate types per chain step, so consecutive-state deltas are
    NOT constant — but rows repeat exactly with period W (probed: the
    1,102-state conformance monster's rows are W-periodic).  Reordering
    states residue-major ((type, step) instead of (step, type)) turns
    every per-(type, class) action into a constant relative delta or a
    constant absolute target — i.e. range-affine, which detect_pieces
    then factorizes (and verifies) as usual.

    Returns a permutation array perm (old id -> new id) or None when
    no period W <= max_w leaves fewer than max_extra aperiodic
    states."""
    S, ncls = dfa.nstates, dfa.nclasses
    if S < 8:
        return None
    t = dfa.trans.astype(np.int64)
    m = dfa.match.astype(np.int64)
    for W in range(1, min(max_w, S // 2) + 1):
        a = np.all(t[W:] == t[:-W], axis=1)
        base = np.arange(S)[:, None]
        rel = t - base
        r = np.all(rel[W:] == rel[:-W], axis=1)
        per_c = (t[W:] == t[:-W]) | (rel[W:] == rel[:-W])
        ok = np.all(per_c, axis=1) & np.all(m[W:] == m[:-W], axis=1)
        # longest contiguous True run in ok (ok[i] covers state i+W)
        if not ok.any():
            continue
        best_len, best_lo = 0, 0
        run_lo = None
        for i, v in enumerate(np.concatenate([ok, [False]])):
            if v and run_lo is None:
                run_lo = i
            elif not v and run_lo is not None:
                if i - run_lo > best_len:
                    best_len, best_lo = i - run_lo, run_lo
                run_lo = None
        if best_len <= 0:
            continue
        H = best_lo            # states [H, T) are W-periodic
        T = best_lo + best_len + W
        if (S - (T - H)) + 2 * W > max_extra:
            continue
        if best_len < 4 * W:
            continue           # not meaningfully periodic
        order = list(range(0, H))
        for rcls in range(W):
            order += list(range(H + rcls, T, W))
        order += list(range(T, S))
        perm = np.zeros(S, np.int64)
        perm[np.asarray(order)] = np.arange(S)
        return perm
    return None


class _PermutedDfa:
    """Renumbered view for detect_pieces (trans/match/nstates only)."""

    def __init__(self, dfa, perm):
        inv = np.argsort(perm)
        self.nstates = dfa.nstates
        self.nclasses = dfa.nclasses
        self.trans = perm[dfa.trans[inv]]
        self.match = dfa.match[inv]


class SpecTablesAffine:
    """Drop-in tables for the spec_* drivers (pallas_scan.py): same
    _scan contract and 3-int32-plane packed format as the wide tier;
    premultiplied states throughout.

    States may be RENUMBERED (residue-major, periodic_perm) to expose
    the affine structure of product chains; the to_premult /
    from_premult hooks keep every driver conversion consistent with
    the ORIGINAL dfa ids (entries, returned states, native repairs)."""

    last_repair = None

    def __init__(self, dfa, max_pieces=MAX_PIECES):
        S, ncls = dfa.nstates, dfa.nclasses
        if ncls > 256:
            raise ValueError("more than 256 byte classes (%d)" % ncls)
        self.perm = None
        try:
            bounds, mode, val, match = detect_pieces(dfa)
            src = dfa
        except ValueError:
            perm = periodic_perm(dfa)
            if perm is None:
                raise
            src = _PermutedDfa(dfa, perm)
            # the renumbered machine may still not be affine (the
            # period was structural luck): detect_pieces re-raises
            bounds, mode, val, match = detect_pieces(src)
            self.perm = perm
            self.inv = np.argsort(perm)
        if len(bounds) > max_pieces:
            raise ValueError("P=%d exceeds the requested piece cap"
                             % len(bounds))
        self.dfa = dfa
        self.nstates = S
        self.ncls = ncls
        self.pieces = len(bounds)
        # static premult breakpoints (compiled as constants)
        self.bp_premult = tuple(int(b) * ncls for b in bounds[1:])
        self.off = S * ncls
        P = self.pieces
        ent = np.zeros(P * ncls, dtype=np.int64)
        for p in range(P):
            for c in range(ncls):
                if mode[p, c]:
                    v = val[p, c] * ncls + self.off
                    e = v | (1 << _MODE_BIT)
                else:
                    e = val[p, c] * ncls
                if match[p, c]:
                    e |= 1 << _MATCH_BIT
                ent[p * ncls + c] = e
        assert int(ent.max()) < 2 ** 31
        self.rows = -(-(P * ncls) // 128)
        self.table = jnp.asarray(ent.astype(np.int32))
        self.bits = 4 if ncls <= 16 else 8
        self.cpw = 8 if self.bits == 4 else 4
        self.warmup = 4 * self.cpw
        self.max_chunk = max_chunk_bytes(self.cpw)
        self.class_map = dfa.class_map.astype(np.uint8)
        self.match_eof = dfa.match_eof

    # driver hooks (pallas_scan spec_* entry points): kernel states
    # live in the RENUMBERED space when perm is set; entries and
    # returned/repair states stay in original dfa ids
    def to_premult(self, s):
        if self.perm is None:
            return s * self.ncls
        return int(self.perm[s]) * self.ncls

    def from_premult(self, p):
        if self.perm is None:
            return p // self.ncls
        return int(self.inv[p // self.ncls])

    def from_premult_vec(self, arr):
        a = np.asarray(arr) // self.ncls
        return a if self.perm is None else self.inv[a]

    def _scan(self, data, state0, j0, C, bad_tail, J, W, COUNT=False,
              mesh=None, axis=None, esc=None):
        return _spec_scan_affine(
            data, state0, j0, self.table, C, bad_tail, W=W,
            CPW=self.cpw, BITS=self.bits, COUNT=COUNT, NCLS=self.ncls,
            BP=self.bp_premult, OFF=self.off, mesh=mesh, axis=axis,
            ESC=esc)


def _affine_step(table, NCLS, BP, OFF):
    """Byte step: piece id by static-breakpoint compares, one
    small-table gather, select(mode, state+delta, absolute)."""
    def step(state, cls):
        pid = jnp.zeros(state.shape, jnp.int32)
        for bp in BP:
            pid = pid + (state >= bp).astype(jnp.int32)
        e = jnp.take(table, pid * NCLS + cls, mode="clip")
        val = e & _VAL_MASK
        rel = (e >> _MODE_BIT) & 1
        nxt = jnp.where(rel == 1, state + val - OFF, val)
        return nxt, (e >> _MATCH_BIT) & 1
    return step


@functools.partial(jax.jit, static_argnames=(
    "W", "CPW", "BITS", "COUNT", "NCLS", "BP", "OFF", "mesh", "axis",
    "ESC"))
def _spec_scan_affine(data, state0, j0, table, C, bad_tail, *, W, CPW,
                      BITS, NCLS, BP, OFF, COUNT=False, mesh=None,
                      axis=None, ESC=None):
    """Driver with the wide tier's contract (3 int32 planes)."""
    def run(d, s0, j0_, t):
        return walk_plain_step(d, s0, j0_, _affine_step(t, NCLS, BP, OFF),
                               W=W, CPW=CPW, BITS=BITS, COUNT=COUNT)

    if mesh is None:
        phi, fm, swarm = run(data, state0, j0, table)
    else:
        from jax.sharding import PartitionSpec as P
        from jax import shard_map
        phi, fm, swarm = shard_map(
            run, mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P()),
            out_specs=(P(axis), P(axis), P(axis)),
            check_vma=False,
        )(data, state0, j0, table)
    summary, _ = _summarize(phi, fm, swarm, state0, C, bad_tail,
                            COUNT, ESC=ESC)
    packed = jnp.stack([phi, fm, swarm])
    return summary, packed
