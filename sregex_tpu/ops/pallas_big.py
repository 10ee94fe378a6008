"""Large-automaton speculative scan (the third table tier).

The narrow tier takes S*ncls <= 128 and the wide tier <= 4096 table
entries.  The reference JIT has no such limit — it compiles EVERY
program (sre_vm_thompson_jit.c:39) — so this tier closes the gap for
automata up to S*ncls <= 2**17 (covers every pattern in the reference
conformance corpus; the largest is 57,816 = 4,818 states x 12
classes).

The walk is the shared flat-table walk (ops/scan_kernel.py): a GPU
load indexes a table of any size, and 2**17 int32 entries (512 KB)
stay in L2.  Encoding matches the other tiers: table[idx] = next*ncls
| match<<20 with idx = state*ncls + class premultiplied (regex ids
never ride the device hot loop — the host resolves them at the
boundary state, see dfa.Dfa.id_at).  Automata with ncls > 16 use
8-bit class packing, 4 classes per int32 word.

Speculation, validation (swarm == entries chain), and the repair path
are shared with the narrow/wide tiers via _summarize; `_scan` has the
same contract, so spec_scan_bytes / spec_count_bytes /
spec_scan_last_bytes drive this tier unchanged.
"""

import numpy as np

from .pallas_scan import _FlatTables, flat_table, max_chunk_bytes

MAX_ENTRIES = 1 << 17      # S*ncls cap: a 512 KB table


class SpecTablesBig(_FlatTables):
    """Host-side preprocessing of a Dfa for the big-table tier."""

    last_repair = None   # see pallas_scan.SpecTables.last_repair

    def __init__(self, dfa):
        S, ncls = dfa.nstates, dfa.nclasses
        if S * ncls > MAX_ENTRIES:
            raise ValueError("automaton too large for the big fused "
                             "table (S*ncls = %d)" % (S * ncls))
        if ncls > 256:
            raise ValueError("more than 256 byte classes (%d)" % ncls)
        self.dfa = dfa
        self.nstates = S
        self.ncls = ncls
        # 4-bit class packing when classes fit a nibble, else 8-bit
        self.bits = 4 if ncls <= 16 else 8
        self.cpw = 8 if self.bits == 4 else 4
        # warmup: 32 bytes regardless of packing (big automata do not
        # converge faster than small ones)
        self.warmup = 32
        self.rows = -(-(S * ncls) // 128)
        self.max_chunk = max_chunk_bytes(self.cpw)
        self.table = flat_table(dfa.trans, dfa.match, ncls)
        self.class_map = dfa.class_map.astype(np.uint8)
        self.match_eof = dfa.match_eof
