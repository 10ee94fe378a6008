"""Pair-step speculative scan: two input bytes per table lookup.

The walk's floor is the LATENCY of the dependent lookup chain.
Composing the transition function over byte PAIRS halves the chain
length: the table becomes

    table2[s*npair + (c1*ncls + c2)] =
        (trans[trans[s,c1],c2] * npair) | (cnt << 20)
    cnt = match[s,c1] + match[trans[s,c1],c2]    (0..2)

and one lookup advances a stream by TWO bytes.  The 2-bit count field
makes COUNT mode exact (the accumulator adds both boundaries) and
keeps the OR-firing flag for scan mode; everything else — chunk
speculation, swarm validation, native repair, the sharded stitch —
is unit-agnostic and reused unchanged (W and j0 are simply halved
into pair units before the walk).

Pair ids are raw c1*ncls+c2 (no alphabet minimization — a remap
would need a second table pass in prep).  Budgets: S*ncls^2 <= 128
(the production default: Scanner tries it first, narrow_only=True)
or <= 1024 entries.  Packing: 4-bit when ncls^2 <= 16 (2 bits of
memory traffic per input byte), else 8-bit (4 bits/byte — the same
traffic as the byte tiers).
"""

import numpy as np

from .pallas_scan import _FlatTables, flat_table, max_chunk_bytes


class SpecTablesPair(_FlatTables):
    """Pair-composed tables; drop-in for SpecTables in every spec_*
    driver (ncls is the PAIR alphabet size — premultiplied states and
    repair-path conversions stay consistent)."""

    MAX_ENTRIES = 1024

    last_repair = None   # see SpecTables.last_repair
    bpu = 2              # bytes per kernel unit

    def __init__(self, dfa, narrow_only=False):
        S, cb = dfa.nstates, dfa.nclasses
        npair = cb * cb
        limit = 128 if narrow_only else self.MAX_ENTRIES
        if S * npair > limit:
            raise ValueError("automaton too large for the pair table "
                             "(S*ncls^2 = %d > %d)" % (S * npair,
                                                       limit))
        if npair > 256:
            raise ValueError("pair alphabet exceeds uint8 (%d)"
                             % npair)
        self.dfa = dfa
        self.nstates = S
        self.byte_ncls = cb
        self.ncls = npair            # pair alphabet (premultiplier)
        self.bits = 4 if npair <= 16 else 8
        self.cpw = 8 if self.bits == 4 else 4    # pairs per word
        # warmup in BYTES; must be a multiple of bpu*cpw
        self.warmup = 4 * self.cpw * 2
        trans = np.asarray(dfa.trans, dtype=np.int64)    # [S, cb]
        match = np.asarray(dfa.match, dtype=np.int64)
        next2 = trans[trans].reshape(S, npair)           # [S, cb*cb]
        cnt2 = (match[:, :, None] + match[trans]).reshape(S, npair)
        self.rows = -(-(S * npair) // 128)
        self.table = flat_table(next2, cnt2, npair)
        self.class_map = dfa.class_map.astype(np.uint8)
        self.match_eof = dfa.match_eof
        self.max_chunk = max_chunk_bytes(self.cpw, bpu=2)
