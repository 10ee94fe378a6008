"""Exact transfer-composition scan (the φ tier): corpus-independent
device rate with ZERO speculation and ZERO native repair.

The speculative tiers (pallas_scan.py) bet that a chunk's entry state
is determined by its trailing warmup window.  Machines whose state
depends on unboundedly old history lose that bet on every chunk —
modular/parity structure ((?:aa)*b), or counted bounds past the
warmup ladder — and degrade to native per-chunk repair.  The
reference never degrades this way: its per-byte cost is
corpus-independent (sre_vm_thompson_x64.dasc:738-889).

This tier restores corpus-independence for S <= 1024 plain-state
machines by computing, per chunk, the FULL transfer function φ: the
exit state (and match count / first-match offset) for EVERY possible
entry state simultaneously — a [chunks, S] state array advanced by
one table gather per byte.  Chunks then compose associatively ON
DEVICE (a tree reduce for counts, jax.lax.associative_scan for first
matches), so the readback is one small summary regardless of corpus
size; prefix transfers give every chunk's true entry for free (the
scan driver pins the match position with one native chunk scan from
the exact entry).  Exactness is unconditional by construction — there
is nothing to validate and nothing to repair.

Data layout: chunk c covers exactly bytes [cK, (c+1)K) (no warmup, no
window overlap), packed into int32 words [Cp, K // cpw]; the ragged
tail finishes natively from the composed exit state.  Per-byte work
is O(S) by construction (a dense transfer needs S trajectories).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .pallas_scan import _MATCH_SHIFT, _STATE_MASK, flat_table

_SENT = np.int32(1 << 30)     # "no match" sentinel for fm lanes
_CHUNK_PAD = 256              # chunk-count granularity (fewer shapes)


class PhiTables:
    """Host-side prep of a Dfa for the φ tier.  S <= 128 plain states,
    S * ncls <= MAX_ENTRIES.  4-bit class packing for ncls <= 16; wide
    alphabets (17..256 classes, e.g. multi-regex fusions with parity
    structure) ride 8-bit data words like the other tiers — half the
    per-word density, same exactness."""

    MAX_STATES = 128
    MAX_ENTRIES = 1024

    def __init__(self, dfa):
        S, ncls = dfa.nstates, dfa.nclasses
        if S > self.MAX_STATES:
            raise ValueError("more than 128 plain states (%d)" % S)
        if ncls > 256:
            raise ValueError("more than 256 byte classes (%d)" % ncls)
        if S * ncls > self.MAX_ENTRIES:
            raise ValueError("S*ncls = %d exceeds the phi budget"
                             % (S * ncls))
        self._init(dfa)

    def _init(self, dfa):
        S, ncls = dfa.nstates, dfa.nclasses
        self.dfa = dfa
        self.nstates = S
        self.ncls = ncls
        self.table = flat_table(dfa.trans, dfa.match, ncls)
        self.class_map = dfa.class_map.astype(np.uint8)
        self.bits = 4 if ncls <= 16 else 8
        self.cpw = 8 if self.bits == 4 else 4
        self.match_eof = dfa.match_eof
        # Scanner.stats() convention; by construction φ scans never
        # repair, so completed scans always record (0, C)
        self.last_repair = None


class PhiTablesBig(PhiTables):
    """φ tier for 128 < S <= 1024 plain states: the exact
    corpus-independent tier must reach the machines that actually hit
    the native-repair floor, e.g. b(?:aa)*b-class parity/counter
    machines with a few hundred states.  Same walk as PhiTables; the
    table is capped at MAX_ROWS 128-entry rows."""

    MAX_STATES = 1024
    MAX_ROWS = 32

    def __init__(self, dfa):
        S, ncls = dfa.nstates, dfa.nclasses
        if S <= 128:
            raise ValueError("S <= 128 rides PhiTables")
        if S > self.MAX_STATES:
            raise ValueError("more than %d plain states (%d)"
                             % (self.MAX_STATES, S))
        if ncls > 256:
            raise ValueError("more than 256 byte classes (%d)" % ncls)
        if -(-(S * ncls) // 128) > self.MAX_ROWS:
            raise ValueError("S*ncls = %d exceeds the big-phi row "
                             "budget" % (S * ncls))
        self._init(dfa)


@functools.partial(jax.jit, static_argnames=(
    "CPW", "BITS", "S", "NCLS", "COUNT", "K"))
def _phi_run(data, table, C, entry_state, *, CPW, BITS, S, NCLS,
             COUNT, K):
    """Per-chunk transfers + on-device composition.  data: int32
    [Cp, K // CPW] packed words.  Returns a small summary:

    COUNT: [exit_plain, total_count]
    scan : [exit_plain, first_abs or -1, fire_chunk or -1,
            fire_entry_plain]
    """
    Cp, Kw = data.shape
    cmask = (1 << BITS) - 1
    entry = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32) * NCLS,
                             (Cp, S))

    def body(w, carry):
        state, acc = carry
        word = lax.dynamic_index_in_dim(data, w, axis=1)    # [Cp, 1]
        for b in range(CPW):
            cls = (word >> (BITS * b)) & cmask
            e = jnp.take(table, state + cls, mode="clip")
            if COUNT:
                acc = acc + (e >> _MATCH_SHIFT)
            else:
                hit = (e >> _MATCH_SHIFT) > 0
                acc = jnp.where(hit & (acc == _SENT), w * CPW + b, acc)
            state = e & _STATE_MASK
        return state, acc

    acc0 = jnp.full((Cp, S), 0 if COUNT else _SENT, jnp.int32)
    phi, acc = lax.fori_loop(0, Kw, body, (entry, acc0))
    # pad chunks (>= C) become IDENTITY transfers so composing over
    # the full padded axis equals composing the real prefix — keeps
    # every shape static (no per-corpus-size recompiles).  Scan mode
    # composes (phi, first-match ABS offset): lengths are uniform (K
    # per chunk), so offsets rebase via fm_abs = c*K + j (_compose).
    cidx = jnp.arange(Cp, dtype=jnp.int32)[:, None]
    phi_cs = jnp.where(cidx < C, phi // NCLS, entry // NCLS)
    acc_cs = jnp.where(cidx < C, acc, jnp.int32(0) if COUNT else _SENT)
    return _compose(phi_cs, acc_cs, C, K, Cp, entry_state, COUNT)


def _compose(phi_cs, acc_cs, C, K, Ctot, entry_state, COUNT):
    """Associative composition of per-chunk transfers; returns the
    summary.  COUNT mode uses a binary TREE REDUCE instead of
    associative_scan — no prefixes are needed for a total, which
    halves the gather work and materializes no prefix arrays."""
    Sp = phi_cs.shape[1]
    cidx = jnp.arange(Ctot, dtype=jnp.int32)[:, None]
    if COUNT:
        n2 = 1 << max(0, (Ctot - 1)).bit_length()
        if n2 != Ctot:
            identr = jnp.broadcast_to(
                jnp.arange(Sp, dtype=jnp.int32), (n2 - Ctot, Sp))
            phi_cs = jnp.concatenate([phi_cs, identr], axis=0)
            acc_cs = jnp.concatenate(
                [acc_cs, jnp.zeros((n2 - Ctot, Sp), jnp.int32)],
                axis=0)
        p, c = phi_cs, acc_cs
        while p.shape[0] > 1:
            pa, pb = p[0::2], p[1::2]      # ordered adjacent pairs
            ca, cb = c[0::2], c[1::2]
            p = jnp.take_along_axis(pb, pa, axis=-1)
            c = ca + jnp.take_along_axis(cb, pa, axis=-1)
        return jnp.stack([p[0, entry_state], c[0, entry_state]])

    fm_abs = jnp.where(acc_cs == _SENT, _SENT, acc_cs + cidx * K)

    def comp2(a, b):
        pa, fa = a
        pb, fb = b
        fbg = jnp.take_along_axis(fb, pa, axis=-1)
        return (jnp.take_along_axis(pb, pa, axis=-1),
                jnp.where(fa != _SENT, fa, fbg))
    pfx_p, pfx_f = lax.associative_scan(comp2, (phi_cs, fm_abs),
                                        axis=0)
    first = pfx_f[-1, entry_state]
    exit_plain = pfx_p[-1, entry_state]
    fire_chunk = jnp.where(first == _SENT, -1, first // K)
    fc = jnp.maximum(fire_chunk, 0)
    fire_entry = jnp.where(
        fc == 0, jnp.int32(entry_state),
        pfx_p[jnp.maximum(fc - 1, 0), entry_state])
    return jnp.stack([exit_plain,
                      jnp.where(first == _SENT, -1, first),
                      fire_chunk, fire_entry])


def phi_prepare(tables, data_np, chunk_len=2048):
    """Pack FULL chunks into [Cp, K // cpw] words.  Returns (device
    data, C_full, K); K is chunk_len rounded down to 64 bytes."""
    K = max(64, (chunk_len // 64) * 64)
    n = len(data_np)
    C = n // K                      # full chunks only (tail on host)
    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    Cp = max(1, -(-C // _CHUNK_PAD)) * _CHUNK_PAD
    cls = np.zeros(Cp * K, dtype=np.uint8)
    cls[:C * K] = tables.class_map[raw[:C * K]]
    nib = cls.reshape(-1, tables.cpw)
    words = nib[:, 0].astype(np.int32)
    for k in range(1, tables.cpw):
        words |= nib[:, k].astype(np.int32) << (tables.bits * k)
    return jnp.asarray(words.reshape(Cp, K // tables.cpw)), C, K


_phi_prepare = phi_prepare


def _phi_dispatch(tables, prepared, C, entry_state, COUNT):
    data, _, K = prepared
    return _phi_run(data, tables.table, jnp.int32(C),
                    jnp.int32(entry_state), CPW=tables.cpw,
                    BITS=tables.bits, S=tables.nstates,
                    NCLS=tables.ncls, COUNT=COUNT, K=K)


def phi_count_bytes(tables, data_np, chunk_len=2048, entry_state=0,
                    prepared=None):
    """Count every interior match boundary (0..n-1); returns
    (final_state, count).  EOF boundary is the caller's
    (tables.match_eof).  Exact with no speculation and no repair."""
    from ..native import NativeDfa
    n = len(data_np)
    if n == 0:
        return entry_state, 0
    if prepared is None:
        prepared = phi_prepare(tables, data_np, chunk_len)
    data, C, K = prepared
    if C == 0:
        return NativeDfa(tables.dfa).count(
            bytes(data_np), entry_state)[::-1]
    summ = np.asarray(
        _phi_dispatch(tables, prepared, C, entry_state,
                      True)).astype(np.int64)
    state, total = int(summ[0]), int(summ[1])
    if C * K < n:                    # ragged tail natively
        raw = np.frombuffer(data_np, dtype=np.uint8) \
            if not isinstance(data_np, np.ndarray) else data_np
        k, state = NativeDfa(tables.dfa).count(
            raw[C * K:].tobytes(), state)
        total += k
    tables.last_repair = (0, C)
    return state, total


def phi_scan_bytes(tables, data_np, chunk_len=2048, entry_state=0,
                   prepared=None):
    """First match boundary; contract of spec_scan_bytes: returns
    (state, boundary or -1) with the state AT the boundary on a match
    (one native chunk scan from the composed exact entry pins it)."""
    from ..native import NativeDfa
    n = len(data_np)
    if n == 0:
        return entry_state, -1
    if prepared is None:
        prepared = phi_prepare(tables, data_np, chunk_len)
    data, C, K = prepared
    native = NativeDfa(tables.dfa)
    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    state = entry_state
    tables.last_repair = None     # set on completed no-match scans
    if C > 0:
        summ = np.asarray(
            _phi_dispatch(tables, prepared, C, entry_state,
                          False)).astype(np.int64)
        state, first, fch, fentry = (int(summ[0]), int(summ[1]),
                                     int(summ[2]), int(summ[3]))
        if first >= 0:
            lo = fch * K
            f, st = native.scan_first(raw[lo:lo + K].tobytes(),
                                      fentry)
            return st, lo + f
    if C * K < n:
        f, st = native.scan_first(raw[C * K:].tobytes(), state)
        if f >= 0:
            return st, C * K + f
        state = st
    tables.last_repair = (0, C)
    return state, -1
