"""Enumerative device DFA scan (the any-size fallback and the
multi-device composition).

A DFA scan is inherently sequential per stream, so this design
parallelizes across the sequence: the input is split into C chunks and
every chunk computes its full *transfer function* — next-state and
first-match-offset for ALL S possible entry states simultaneously
(enumerative data-parallel FSM execution).  Chunk functions compose
associatively, so the final result is a log-depth reduction; across
devices the same composition rides all_gather of S-sized vectors
(parallel/sharded_scan.py).

Correctness contract: identical boundary semantics to the host DFA
engine (dfa.py DfaCtx), which itself is byte-exact against the
reference Thompson/JIT engines on the full conformance corpus:
  - match[s][byte] is checked at boundary i BEFORE consuming byte i
  - EOF acceptance is a separate vector, applied by the caller

Layout choices:
  - chunks x states arrays [C, S] (S padded to a multiple of 128 so
    few distinct shapes compile);
  - the fused table is byte-major [256, S]: consuming byte b selects a
    row, then the per-state gather is a take_along_axis over S;
  - match bit is fused into the table's high bits: one gather per byte
    yields both the next state and the boundary-match flag.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

_MATCH_SHIFT = 20
_ID_SHIFT = 21
_MAX_DEV_ID = (1 << (31 - _ID_SHIFT)) - 1   # 1023 ids in device tables
_STATE_MASK = (1 << _MATCH_SHIFT) - 1
_NO_MATCH = np.int32(2 ** 30)      # +inf sentinel, chunk-RELATIVE offsets
_NO_MATCH_ABS = np.int64(2 ** 62)  # +inf sentinel, block-ABSOLUTE offsets
# Chunk-relative first-match offsets are bounded by chunk_len and stay
# int32; the moment offsets become block-absolute (reduce_summaries,
# sharded composition) they are widened to int64 so corpora past 2 GiB
# (and sharded aggregates past any int32 bound) keep exact offsets.


def dfa_device_tables(dfa):
    """Build device-resident tables from a host Dfa.

    Returns a dict with:
      fused_bm : int32 [256, S]  byte-major fused:
                 next | match<<20 | regex_id<<21 (id 0 when no match;
                 ids clamp at 1023 — resolve >1023 via dfa.match_id)
      match_eof: int32 [S]       1 where EOF-acceptance holds
      match_eof_id: int32 [S]    regex id of the EOF match, or -1
      nstates  : python int (unpadded)
    S is padded to a multiple of 128 with dead self-loop states.
    """
    S = dfa.nstates
    Sp = max(128, -(-S // 128) * 128)
    trans = dfa.trans_bytes.astype(np.int32)      # [S, 256]
    match = dfa.match_bytes.astype(np.int32)      # [S, 256]
    mid = np.clip(dfa.match_id_bytes, 0, _MAX_DEV_ID).astype(np.int32)
    fused = trans | (match << _MATCH_SHIFT) | (mid << _ID_SHIFT)
    fused_bm = np.full((256, Sp), 0, dtype=np.int32)
    fused_bm[:, :S] = fused.T
    # padded states: self-loop, no match
    for s in range(S, Sp):
        fused_bm[:, s] = s
    match_eof = np.zeros(Sp, dtype=np.int32)
    match_eof[:S] = dfa.match_eof.astype(np.int32)
    match_eof_id = np.full(Sp, -1, dtype=np.int32)
    match_eof_id[:S] = dfa.match_eof_id.astype(np.int32)
    return {
        "fused_bm": jnp.asarray(fused_bm),
        "match_eof": jnp.asarray(match_eof),
        "match_eof_id": jnp.asarray(match_eof_id),
        "nstates": S,
        "nstates_padded": Sp,
    }


@functools.partial(jax.jit, static_argnames=("chunk_len",))
def chunk_transfer(fused_bm, data, valid_len, *, chunk_len):
    """Per-chunk transfer functions.

    fused_bm : int32 [256, S]
    data     : uint8 [C, K] chunked input (K == chunk_len, padded)
    valid_len: int32 [C] number of valid bytes per chunk

    Returns (phi [C, S] int32, fm [C, S] int32, fid [C, S] int32):
      phi[c, s] = state after running chunk c from entry state s
      fm[c, s]  = offset within chunk c of the earliest boundary with a
                  match when entering in state s, else _NO_MATCH.
      fid[c, s] = regex id of that earliest match, else -1 (multi-
                  pattern programs: which pattern matched first —
                  sre_vm_pike.c:607-658).
    Boundary semantics: fm records boundary j (before consuming
    byte j); the boundary at the chunk's end belongs to the next chunk.
    """
    C, K = data.shape
    S = fused_bm.shape[1]
    state0 = jnp.broadcast_to(
        lax.broadcasted_iota(jnp.int32, (C, S), 1), (C, S))
    fm0 = jnp.full((C, S), _NO_MATCH, dtype=jnp.int32)
    fid0 = jnp.full((C, S), -1, dtype=jnp.int32)

    def step(j, carry):
        state, fm, fid = carry
        b = data[:, j].astype(jnp.int32)                   # [C]
        rows = jnp.take(fused_bm, b, axis=0)               # [C, S]
        e = jnp.take_along_axis(rows, state, axis=1)       # [C, S]
        m = e >> _MATCH_SHIFT
        nxt = e & _STATE_MASK
        valid = (j < valid_len)[:, None]                   # [C, 1]
        fire = valid & (m > 0)
        # j is monotone, so the first fire wins and later fires never
        # touch fm/fid again
        first_fire = fire & (fm == _NO_MATCH)
        fid = jnp.where(first_fire, e >> _ID_SHIFT, fid)
        fm = jnp.minimum(fm, jnp.where(fire, j, _NO_MATCH))
        state = jnp.where(valid, nxt, state)
        return state, fm, fid

    phi, fm, fid = lax.fori_loop(0, K, step, (state0, fm0, fid0))
    return phi, fm, fid


def compose(a, b):
    """Associative composition of transfer summaries applied a-then-b.
    Each summary is (phi [.., S], fm [.., S], fid [.., S]) with fm
    int64 in ABSOLUTE offsets (use _NO_MATCH_ABS sentinel)."""
    phi_a, fm_a, fid_a = a
    phi_b, fm_b, fid_b = b
    phi = jnp.take_along_axis(phi_b, phi_a, axis=-1)
    fm_bc = jnp.take_along_axis(fm_b, phi_a, axis=-1)
    fid_bc = jnp.take_along_axis(fid_b, phi_a, axis=-1)
    use_a = fm_a <= fm_bc
    fm = jnp.where(use_a, fm_a, fm_bc)
    fid = jnp.where(use_a, fid_a, fid_bc)
    return phi, fm, fid


def reduce_summaries(phi, fm, fid, valid_len):
    """Log-depth composition of per-chunk transfer summaries into one
    block summary (phi [S], fm [S], fid [S]; fm int64 in
    block-absolute offsets).

    Kept as a separate dispatch from chunk_transfer (the reduction is
    light and compiles on its own).
    Runs under enable_x64 so absolute offsets are genuine int64 (a >2
    GiB buffer otherwise loses matches past the int32 sentinel).
    """
    with jax.enable_x64():
        return _reduce_summaries(phi, fm, fid, valid_len)


@jax.jit
def _reduce_summaries(phi, fm, fid, valid_len):
    C, S = phi.shape
    base = jnp.cumsum(valid_len.astype(jnp.int64)) - valid_len
    fm = jnp.where(fm >= _NO_MATCH, _NO_MATCH_ABS,
                   fm.astype(jnp.int64) + base[:, None])
    # pad chunk count to a power of two with identity summaries
    n = 1
    while n < C:
        n *= 2
    if n != C:
        ident_phi = jnp.broadcast_to(
            lax.broadcasted_iota(jnp.int32, (n - C, S), 1), (n - C, S))
        ident_fm = jnp.full((n - C, S), _NO_MATCH_ABS, jnp.int64)
        ident_fid = jnp.full((n - C, S), -1, jnp.int32)
        phi = jnp.concatenate([phi, ident_phi], axis=0)
        fm = jnp.concatenate([fm, ident_fm], axis=0)
        fid = jnp.concatenate([fid, ident_fid], axis=0)
    while n > 1:
        half = n // 2
        phi2 = phi.reshape(half, 2, S)
        fm2 = fm.reshape(half, 2, S)
        fid2 = fid.reshape(half, 2, S)
        phi, fm, fid = compose((phi2[:, 0], fm2[:, 0], fid2[:, 0]),
                               (phi2[:, 1], fm2[:, 1], fid2[:, 1]))
        n = half
    return phi[0], fm[0], fid[0]


def scan_block(fused_bm, data, valid_len, *, chunk_len):
    """Scan a [C, K] block: returns the whole block's transfer summary
    (phi [S], fm [S], fid [S] with fm in block-absolute offsets).  Two
    device dispatches: the heavy per-chunk transfer and the light
    reduction."""
    phi, fm, fid = chunk_transfer(fused_bm, data, valid_len,
                                  chunk_len=chunk_len)
    return reduce_summaries(phi, fm, fid, valid_len)


def scan_bytes(tables, data_np, chunk_len=2048, entry_state=0):
    """Host-facing whole-buffer scan.  Returns (final_state:int,
    first_match_end:int or -1, regex_id:int or -1) for the given entry
    state.

    first_match_end is the earliest boundary (0..N-1) at which a match
    ends (Thompson SRE_OK boundary); the EOF boundary (N) is NOT
    included — callers check tables['match_eof'][final_state] and, for
    the id, tables['match_eof_id'][final_state].
    """
    n = len(data_np)
    if n == 0:
        return entry_state, -1, -1
    K = int(chunk_len)
    C = -(-n // K)
    padded = np.zeros(C * K, dtype=np.uint8)
    padded[:n] = np.frombuffer(data_np, dtype=np.uint8)
    data = jnp.asarray(padded.reshape(C, K))
    valid = np.full(C, K, dtype=np.int32)
    valid[-1] = n - (C - 1) * K
    phi, fm, fid = scan_block(tables["fused_bm"], data,
                              jnp.asarray(valid), chunk_len=K)
    phi = np.asarray(phi)
    fm = np.asarray(fm)
    fid = np.asarray(fid)
    final_state = int(phi[entry_state])
    first = int(fm[entry_state])
    if first >= int(_NO_MATCH_ABS):
        return final_state, -1, -1
    return final_state, first, int(fid[entry_state])
