"""Device TDFA scan: capture registers and match banks updated by
vectorized select inside the chunk walk — the north-star "capture
slots update via vectorized select" path.

The host TDFA (sregex_tpu/tdfa.py) proves that one Pike step
determinizes to, per (state, byte class):

  - a next state,
  - a register rebuild: new_reg[k] = one of {old reg j, UNSET,
    CURRENT position, NEXT position},
  - at most one commit: bank[t] = resolved source per tag, plus the
    regex id.

Those source codes are packed into per-(state,class) nibble tables; the
walk advances every chunk stream with 4 table gathers per byte and
resolves every register/bank slot with a short select chain (plain
jax.numpy/lax: no capture workload has a device kernel of its own).  This
subsumes the reference's capture machinery (sre_vm_pike.c:814-837 SAVE
closure, sre_capture.c:59-85 COW update) as branch-free dataflow.

Chunk speculation (same discipline as ops/pallas_scan.py): the state
converges through the warmup window; REGISTERS are not speculated —
they start each chunk as BAD sentinels, and any value that survives
from before the window start stays BAD.  A bank whose positions are all
real (>= 0) was therefore committed entirely from bytes the chunk
actually saw and is exact once the state chain validates.  Anything
else (speculation miss, ragged tail, BAD positions, i.e. a match
longer than the chunk+warmup window) returns None and the caller falls
back to the exact multi-pass path — exactness is unconditional,
speed is for the common case.

Constraints: S * nclasses <= MAX_ENTRIES (the four per-(state,class)
tables are flat arrays indexed by the premultiplied state + class),
byte classes <= 16 ride 4-bit packed data words; 17..256 classes use
8-bit packing (cpw=4, the chunk clamp of pallas_scan.max_chunk_bytes
like every tier), registers/tags <= 13 with 4-bit source codes or
<= 24 (R_MAX8/T_MAX8) with byte codes, regex ids <= 127.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..tdfa import Tdfa, TdfaTooLarge, SRC_UNSET, SRC_CUR, SRC_NEXT, \
    CTX_BOS
from .pallas_scan import GROUPS, TILE, _prepare, max_chunk_bytes

_BAD = np.int32(-(2 ** 30))

# source codes: register ids, then the three specials (UNSET, CUR,
# NEXT) at the top of the code space.  Machines with regs/tags <= 13
# pack 4-bit codes (8 slots per int32 plane — the hot path gathers
# ONE regsrc plane when R <= 8); larger machines switch to 8-bit
# codes (4 slots per plane, more gathers and a longer resolve chain)
# up to R_MAX8/T_MAX8.  Past that, the exact multi-pass path covers.
R_MAX = 13
T_MAX = 13
R_MAX8 = 24     # byte-code planes: 11-group patterns one-pass
T_MAX8 = 24
R_MAX16 = 48    # 16-bit code planes (2 slots/plane): >= 16-group
T_MAX16 = 48    # patterns one-pass; resolve chains are R^2 selects
                # per byte, so only the machines that need them pay
MAX_ENTRIES = 512        # S * ncls budget of the dense tables


def _specials(code_bits):
    """(UNSET, CUR, NEXT) codes: the top three of the code space, so
    register ids run 0 .. 2^bits - 4."""
    top = (1 << code_bits) - 1
    return top - 2, top - 1, top


def _src_code(src, code_bits):
    c_unset, c_cur, c_next = _specials(code_bits)
    if src == SRC_UNSET:
        return c_unset
    if src == SRC_CUR:
        return c_cur
    if src == SRC_NEXT:
        return c_next
    if src >= c_unset:
        raise TdfaTooLarge("register id %d exceeds the %d-bit code "
                           "space" % (src, code_bits))
    return src              # old register id


def _pack_planes(t, kernel_sids, full2k, ncls, esc=None, R=R_MAX,
                 T=T_MAX, code_bits=4):
    """Pack the source-code planes for the kernel over a state subset.

    kernel_sids[k] = full sid of kernel state k; full2k maps full sid
    -> kernel id.  esc (kernel id or None): transitions leaving the
    subset go to the ESC sink (its own row: self-loop, no rebuilds,
    no commits) — the hot-core projection.  Returns (rows, planes)
    with planes = (t_next [E], t_regsrc [PR, E], t_csrc [PT, E],
    t_cmeta [E]) flat over E = rows*128 entries; PR/PT =
    ceil(R/slots-per-plane) stacked int32 code planes (slot k lives
    in plane k//spp at bit code_bits*(k%spp))."""
    n_k = len(kernel_sids) + (1 if esc is not None else 0)
    rows = -(-(n_k * ncls) // 128)
    spp = 32 // code_bits
    c_unset, _, _ = _specials(code_bits)
    t_next = np.zeros(rows * 128, dtype=np.int32)
    # per-slot code arrays; packed into int32 planes at the end (the
    # kernel masks after arithmetic shifts, so codes landing in the
    # sign bit are harmless)
    reg_codes = np.full((rows * 128, max(1, R)), c_unset,
                        dtype=np.uint32)
    bank_codes = np.zeros((rows * 128, max(1, T)), dtype=np.uint32)
    t_cmeta = np.zeros(rows * 128, dtype=np.int32)
    for k, s in enumerate(kernel_sids):
        for c in range(ncls):
            nsid, ops, commit = t.step(s, c)
            idx = k * ncls + c
            nk = full2k.get(nsid, esc)
            t_next[idx] = nk * ncls
            for d, src in ops:
                if d >= R:
                    # only reachable for a hot-core projection: the
                    # target state is off-core (nk == esc), so its
                    # extra registers are never trusted — drop them
                    if esc is None or nk != esc:
                        raise TdfaTooLarge(
                            "register slot %d exceeds the packing "
                            "(R=%d)" % (d, R))
                    continue
                reg_codes[idx, d] = _src_code(src, code_bits)
            if commit is not None:
                srcs, rid = commit
                for ti, src in enumerate(srcs):
                    bank_codes[idx, ti] = _src_code(src, code_bits)
                t_cmeta[idx] = 1 | (rid << 1)
    if esc is not None:
        for c in range(ncls):
            idx = esc * ncls + c
            t_next[idx] = esc * ncls
            # reg_codes rows are pre-filled UNSET

    def bc(v):
        return jnp.asarray(np.ascontiguousarray(v))

    def pack(codes, n):
        P = max(1, -(-n // spp))
        out = np.zeros((P, rows * 128), dtype=np.uint32)
        for k in range(codes.shape[1]):
            out[k // spp] |= codes[:, k] << np.uint32(
                code_bits * (k % spp))
        return out.view(np.int32)

    planes = (
        bc(t_next),
        bc(pack(reg_codes, R)),
        bc(pack(bank_codes, T)),
        bc(t_cmeta),
    )
    return rows, planes


class TdfaSpecTables:
    """Host-side compilation of a (lazy) Tdfa into dense nibble tables
    for the device kernel.  Materializes every reachable state by BFS
    over byte classes; raises TdfaTooLarge when the automaton exceeds
    the narrow-kernel budgets."""

    def __init__(self, prog, tags=None, chunk_len=2048):
        if tags is None:
            if prog.ovecsize <= T_MAX16:
                tags = tuple(range(prog.ovecsize))
            else:
                tags = []
                ofs = 0
                for i in range(prog.nregexes):
                    tags += [ofs, ofs + 1]
                    ofs += 2 * (prog.multi_ncaps[i] + 1)
                tags = tuple(tags)
        if len(tags) > T_MAX16:
            raise TdfaTooLarge("too many tracked tags (%d)" % len(tags))
        if prog.nregexes > 127:
            raise TdfaTooLarge("too many regexes (%d)" % prog.nregexes)
        budget = MAX_ENTRIES
        t = Tdfa(prog, tags=tags, max_states=max(256, budget // 2),
                 max_regs=R_MAX16)
        self.tdfa = t
        self.tags = tags
        self.ncls = t.nclasses
        if t.nclasses > 256:
            raise TdfaTooLarge("more than 256 byte classes (%d): "
                               "class ids must fit the 8-bit data "
                               "words" % t.nclasses)

        # materialize (transitions build states lazily)
        frontier = list(range(t.nstates))
        seen = set(frontier)
        i = 0
        while i < len(frontier):
            sid = frontier[i]
            i += 1
            for c in range(t.nclasses):
                nsid, _, _ = t.step(sid, c)
                if t.nstates * t.nclasses > budget:
                    raise TdfaTooLarge(
                        "TDFA too large for the device kernel "
                        "(S*ncls=%d > %d)"
                        % (t.nstates * t.nclasses, budget))
                if nsid not in seen:
                    seen.add(nsid)
                    frontier.append(nsid)
        S = t.nstates
        if S * t.nclasses > budget:
            raise TdfaTooLarge("S*ncls=%d" % (S * t.nclasses))

        self.nstates = S
        self.nregs = max(t.nregs(s) for s in range(S))
        self.ntags = len(tags)
        ncls = t.nclasses

        dead = -1
        for s in range(S):
            if t.is_dead(s):
                dead = s * ncls
        self.dead_premult = dead
        self.seed_premult = t.seed_state(CTX_BOS) * ncls
        self.seed_nregs = t.nregs(t.seed_state(CTX_BOS))

        # 4-bit codes when regs AND tags fit 13; byte codes (more
        # gathers + longer resolve chains — only the machines that
        # need them pay) up to R_MAX8/T_MAX8
        self.code_bits = (
            4 if (self.nregs <= R_MAX and self.ntags <= T_MAX)
            else 8 if (self.nregs <= R_MAX8 and self.ntags <= T_MAX8)
            else 16)
        self.rows, planes = _pack_planes(
            t, list(range(S)), {s: s for s in range(S)}, ncls,
            esc=None, R=self.nregs, T=self.ntags,
            code_bits=self.code_bits)
        (self.t_next, self.t_regsrc, self.t_csrc,
         self.t_cmeta) = planes

        # reuse the boolean tiers' data prep (same packing/layout);
        # >16 classes take 8-bit words
        if ncls > 16:
            self.bits = 8
            self.cpw = 4
        else:
            self.bits = 4
            self.cpw = 8
        self.warmup = 4 * self.cpw
        self.max_chunk = max_chunk_bytes(self.cpw)
        self.class_map = t.class_map.astype(np.uint8)

    # kernel <-> full state id mapping (identity for the full tables;
    # the hot-core projection overrides both)
    is_core = False

    def to_kernel_premult(self, sid):
        return sid * self.ncls

    def from_kernel_premult(self, premult):
        return premult // self.ncls


class TdfaCoreTables(TdfaSpecTables):
    """Hot-core projection of a tagged DFA for the capture kernel —
    the tagged analogue of ops/pallas_core.CoreTables (VERDICT r2 #1:
    'core-sampled variants ... the way pallas_scan.py grew
    CoreTables').

    The full (lazy) Tdfa materializes only the states a corpus sample
    actually visits; the kernel tables cover that hot set plus an ESC
    sink absorbing every transition that leaves it.  A chunk whose
    walk stays in-core rebuilds registers and commits banks EXACTLY
    like the full machine (the nibble codes are state-local, so the
    projection changes only the next-state ids); a chunk that hits
    ESC simply fails chain validation and re-walks on the host TDFA
    inside the standard chunk-repair fold — exactness is
    unconditional, the sample only sets the escape rate.

    One-pass device captures thus extend past the dense budget
    (S*ncls <= MAX_ENTRIES) to any tagged machine whose HOT set fits,
    e.g. counted-repetition capture patterns whose state count
    explodes but whose corpus-visited core is small."""

    MAX_ESCAPE_FRAC = 1e-5      # sampled visit mass allowed off-core

    def __init__(self, prog, sample, tags=None, chunk_len=2048,
                 max_escape_frac=None):
        if max_escape_frac is None:
            max_escape_frac = self.MAX_ESCAPE_FRAC
        if tags is None:
            if prog.ovecsize <= T_MAX16:
                tags = tuple(range(prog.ovecsize))
            else:
                tags = []
                ofs = 0
                for i in range(prog.nregexes):
                    tags += [ofs, ofs + 1]
                    ofs += 2 * (prog.multi_ncaps[i] + 1)
                tags = tuple(tags)
        if len(tags) > T_MAX16:
            raise TdfaTooLarge("too many tracked tags (%d)"
                               % len(tags))
        if prog.nregexes > 127:
            raise TdfaTooLarge("too many regexes (%d)" % prog.nregexes)
        # registers are UNBOUNDED on the full machine — host re-walks
        # handle any count; only the HOT transitions must fit the
        # kernel's code space (checked below / in _pack_planes)
        t = Tdfa(prog, tags=tags, max_states=1 << 14, max_regs=None)
        self.tdfa = t
        self.tags = tags
        self.ncls = t.nclasses
        if t.nclasses > 256:
            raise TdfaTooLarge("more than 256 byte classes (%d)"
                               % t.nclasses)
        if not isinstance(sample, (bytes, bytearray)):
            sample = bytes(sample)
        if not sample:
            raise TdfaTooLarge("empty sample")

        # sample walk: visit counts per full sid (materializes states)
        seed = t.seed_state(CTX_BOS)
        counts = {}
        sid = seed
        arr = t.class_map[np.frombuffer(sample, dtype=np.uint8)]
        for c in arr:
            counts[sid] = counts.get(sid, 0) + 1
            sid, _, _ = t.step(sid, int(c))
        counts[seed] = counts.get(seed, 0) + 1
        total = float(sum(counts.values()))

        budget = MAX_ENTRIES
        ncls = t.nclasses
        h_cap = budget // ncls - 1          # ESC takes one row block
        order = sorted(counts, key=lambda s: -counts[s])
        if seed in order:
            order.remove(seed)
        order = [seed] + order
        hot = order[:h_cap]
        off = sum(counts[s] for s in order[h_cap:])
        if off > max_escape_frac * total:
            raise TdfaTooLarge(
                "sampled hot set exceeds the core budget "
                "(%d visited, %d allowed, %.2g off-core mass)"
                % (len(order), h_cap, off / total))
        H = len(hot)
        self.hot2full = list(hot)
        self.full2core = {s: k for k, s in enumerate(hot)}
        self.H = H
        self.esc_k = H
        self.nstates = H + 1

        self.nregs = max(t.nregs(s) for s in hot)
        if self.nregs > R_MAX16:
            raise TdfaTooLarge("hot states need %d registers (> %d)"
                               % (self.nregs, R_MAX16))
        self.ntags = len(tags)
        self.seed_premult = self.full2core[seed] * ncls
        self.seed_nregs = t.nregs(seed)
        dead = -1
        for s in hot:
            if t.is_dead(s):
                dead = self.full2core[s] * ncls
        self.dead_premult = dead            # -1: never triggers

        self.code_bits = (
            4 if (self.nregs <= R_MAX and self.ntags <= T_MAX)
            else 8 if (self.nregs <= R_MAX8 and self.ntags <= T_MAX8)
            else 16)
        self.rows, planes = _pack_planes(
            t, hot, self.full2core, ncls, esc=self.esc_k,
            R=self.nregs, T=self.ntags, code_bits=self.code_bits)
        if self.rows * 128 > budget:
            raise TdfaTooLarge("core rows exceed the budget")
        (self.t_next, self.t_regsrc, self.t_csrc,
         self.t_cmeta) = planes

        if ncls > 16:
            self.bits = 8
            self.cpw = 4
        else:
            self.bits = 4
            self.cpw = 8
        self.warmup = 4 * self.cpw
        self.max_chunk = max_chunk_bytes(self.cpw)
        self.class_map = t.class_map.astype(np.uint8)

    is_core = True

    def to_kernel_premult(self, sid):
        k = self.full2core.get(sid)
        return None if k is None else k * self.ncls

    def from_kernel_premult(self, premult):
        k = premult // self.ncls
        return None if k >= self.H else self.hot2full[k]


def _resolve(code, regs, j_cur, j_next, code_bits):
    """Select-chain resolution of a source code."""
    c_unset, c_cur, c_next = _specials(code_bits)
    v = jnp.full(code.shape, _BAD, jnp.int32)
    for k in range(len(regs)):
        v = jnp.where(code == k, regs[k], v)
    v = jnp.where(code == c_unset, jnp.int32(-1), v)
    v = jnp.where(code == c_cur, jnp.int32(j_cur), v)
    v = jnp.where(code == c_next, jnp.int32(j_next), v)
    return v


def _tdfa_walk(data, state0, j0, t_next, t_regsrc, t_csrc, t_cmeta, *,
               W, CPW, BITS, CODE, R, T):
    """All chunk streams at once ([B, G, 8, 128] each), one byte per
    loop iteration.  data [B, J//CPW, G, 8, 128] packed classes (BITS
    per class); regsrc/csrc are stacked code planes [P, E] (CODE bits
    per slot, 32 // CODE slots per plane); only the planes a machine's
    R/T actually reach cost a gather."""
    spp = 32 // CODE
    PR = max(1, -(-R // spp))
    PT = max(1, -(-T // spp))
    J = data.shape[1] * CPW
    shape = state0.shape

    def gath(tab, idx):
        return jnp.take(tab, idx, mode="clip")

    def one_byte(j, state, regs, bank, live):
        """live: traced bool — False freezes (warmup of the true-entry
        stream).  j is a traced scalar (window position)."""
        word = lax.dynamic_index_in_dim(data, j // CPW, axis=1,
                                        keepdims=False)
        cls = (word >> (BITS * (j % CPW))) & ((1 << BITS) - 1)
        idx = state + cls
        e = gath(t_next, idx)
        cm = gath(t_cmeta, idx)
        rs = [gath(t_regsrc[p], idx) for p in range(PR)]
        cs = [gath(t_csrc[p], idx) for p in range(PT)]

        def codeof(planes, k):
            return (planes[k // spp] >> (CODE * (k % spp))) \
                & ((1 << CODE) - 1)

        newregs = tuple(
            _resolve(codeof(rs, k), regs, j, j + 1, CODE)
            for k in range(R))
        has = (cm & 1) == 1
        newbank = tuple(
            jnp.where(has,
                      _resolve(codeof(cs, t), regs, j, j + 1, CODE),
                      bank[t])
            for t in range(T))
        newrid = jnp.where(has, cm >> 1, bank[T])
        newbank = newbank + (newrid,)
        state = jnp.where(live, e, state)
        regs = tuple(jnp.where(live, newregs[k], regs[k])
                     for k in range(R))
        bank = tuple(jnp.where(live, newbank[t], bank[t])
                     for t in range(T + 1))
        return state, regs, bank

    # true-entry stream (j0 > 0): registers = seed position (= j0);
    # speculative streams: BAD
    regs = tuple(jnp.where(j0 > 0, j0, _BAD) for _ in range(R))
    bank = tuple(jnp.full(shape, _BAD, jnp.int32) for _ in range(T))
    bank = bank + (jnp.full(shape, -1, jnp.int32),)

    # warmup: j in [0, W) with per-stream freeze below j0.  The
    # speculative warmup advances the STATE only: a register value
    # rebuilt here would reflect the fresh-from-seed trajectory, not
    # the true machine's — the validation chain proves the states
    # CONVERGE by the window end, not that the registers agree (the
    # whole point of TDFA registers is distinguishing configurations
    # the state id merges).  Keeping regs/bank BAD-tainted through
    # the warmup makes certification sound: a commit in the covered
    # region is exact iff every source was rebuilt at j >= W, where
    # the trajectory provably equals the true one; anything tracing
    # to the entry or the warmup stays BAD and forces the fallback.
    # (The true-entry stream is frozen below j0 = W and unaffected.)
    def warm_step(j, state):
        ns, _, _ = one_byte(j, state, regs, bank, j >= j0)
        return ns

    swarm = lax.fori_loop(0, W, warm_step, state0)

    def step(j, carry):
        state, rg, bk = carry
        return one_byte(j, state, rg, bk, jnp.bool_(True))

    phi, regs, bank = lax.fori_loop(W, J, step, (swarm, regs, bank))
    regs = jnp.stack(regs) if R else jnp.zeros((0,) + shape, jnp.int32)
    return phi, swarm, jnp.stack(bank), regs


@functools.partial(jax.jit,
                   static_argnames=("W", "CPW", "BITS", "CODE", "R",
                                    "T"))
def _tdfa_scan(data, state0, j0, t_next, t_regsrc, t_csrc, t_cmeta,
               C, dead_val, *, W, CPW, BITS, CODE, R, T):
    """Returns (summary int32 [10 + T+1 + R], bank planes, regs planes).

    Device-side validation and result extraction:
      [0] all_ok (chain valid through the covered chunks)
      [1] fb — first broken chunk (C if none)
      [2] dead_chunk — first chunk (in the valid prefix) whose exit
          state is dead (C if none)
      [3] lc — last chunk <= dead_chunk with a committed bank (-1 none)
      [4] phi @ end of the covered region      [5] entries@fb
      [6] swarm@fb  [7] phi@fb  [8] C  [9] reserved
      [10 .. 10+T] bank values + rid @ lc
      [10+T+1 ..]  exit registers @ the last covered chunk
    """
    phi, swarm, bank, regs = _tdfa_walk(
        data, state0, j0, t_next, t_regsrc, t_csrc, t_cmeta, W=W,
        CPW=CPW, BITS=BITS, CODE=CODE, R=R, T=T)

    Cp = phi.size
    phi_f = phi.reshape(Cp)
    swarm_f = swarm.reshape(Cp)
    bank_f = bank.reshape(T + 1, Cp)
    regs_f = regs.reshape(R, Cp)
    e0 = state0.reshape(Cp)[0]
    entries = jnp.concatenate([e0[None], phi_f[:-1]])
    idx = jnp.arange(Cp, dtype=jnp.int32)
    okv = (swarm_f == entries) | (idx >= C)
    all_ok = jnp.all(okv)
    fb = jnp.where(all_ok, C,
                   jnp.argmin(okv.astype(jnp.int32)).astype(jnp.int32))
    # the scan ENDS at the first dead exit; chunks after it never
    # converge to dead (speculation wanders live states), so the chain
    # only needs to validate up to and including the death chunk
    deadv = (phi_f == dead_val) & (idx < C)
    any_dead = jnp.any(deadv)
    first_dead = jnp.where(
        any_dead, jnp.argmax(deadv.astype(jnp.int32)).astype(jnp.int32),
        C)
    ended = first_dead < fb
    ok = all_ok | ended
    scan_end = jnp.where(ended, first_dead + 1, C)
    hasc = (bank_f[T] >= 0) & (idx < scan_end)
    lc = jnp.max(jnp.where(hasc, idx, -1)).astype(jnp.int32)
    lce = jnp.maximum(lc, 0)
    last_cov = jnp.maximum(scan_end - 1, 0)
    summary = jnp.concatenate([
        jnp.stack([ok.astype(jnp.int32), fb, first_dead, lc,
                   phi_f[last_cov], entries[jnp.minimum(fb, Cp - 1)],
                   swarm_f[jnp.minimum(fb, Cp - 1)],
                   phi_f[jnp.minimum(fb, Cp - 1)], C,
                   jnp.int32(0)]),
        bank_f[:, lce],
        regs_f[:, last_cov],
    ])
    return summary, phi_f, swarm_f, bank_f, regs_f


def _host_walk(tables, sid, regs, bank, rid, data_np, pos, n):
    """Sequential table walk over data_np[pos:n] + the EOF boundary,
    continuing from (sid, regs, bank, rid).  regs entries may be None
    (BAD: value predates the known window) — touching one forces a
    fallback.  Returns (rid, bank) | None | "fallback"."""
    t = tables.tdfa
    if pos < n:
        cmap = t.class_map
        raw = np.frombuffer(data_np, dtype=np.uint8) \
            if not isinstance(data_np, np.ndarray) else data_np
        arr = cmap[raw[pos:n]]
        for i_ in range(n - pos):
            nsid, ops, commit = t.step(sid, int(arr[i_]))
            cur = pos + i_
            nxt = cur + 1

            def res(s):
                if s == SRC_UNSET:
                    return -1
                if s == SRC_CUR:
                    return cur
                if s == SRC_NEXT:
                    return nxt
                return regs[s]
            if commit is not None:
                bank = [res(s) for s in commit[0]]
                rid = commit[1]
            if ops:
                regs = [res(s) for _d, s in ops]
            else:
                regs = []
            sid = nsid
            if t.is_dead(sid):
                break
    if t.is_dead(sid):
        if bank is None:
            return None
        if any(b is None for b in bank):
            return "fallback"
        return rid, bank

    commit = t.eof_step(sid)
    if commit is not None:
        def res_eof(s):
            if s == SRC_UNSET:
                return -1
            if s == SRC_CUR or s == SRC_NEXT:
                return n
            return regs[s]
        bank = [res_eof(s) for s in commit[0]]
        rid = commit[1]
    if bank is None:
        return None
    if any(b is None for b in bank):
        return "fallback"
    return rid, bank



def _walk_chunk(t, sid, regs, bank, rid, raw, lo, hi):
    """Host TDFA walk over raw[lo:hi] from (sid, regs); returns the
    carried (sid, regs, bank, rid).  Positions are absolute."""
    cmap = t.class_map
    arr = cmap[raw[lo:hi]]
    for i_ in range(hi - lo):
        nsid, ops, commit = t.step(sid, int(arr[i_]))
        cur = lo + i_
        nxt = cur + 1

        def res(s):
            if s == SRC_UNSET:
                return -1
            if s == SRC_CUR:
                return cur
            if s == SRC_NEXT:
                return nxt
            return regs[s]
        if commit is not None:
            bank = [res(s) for s in commit[0]]
            rid = commit[1]
        regs = [res(s) for _d, s in ops] if ops else []
        sid = nsid
        if t.is_dead(sid):
            break
    return sid, regs, bank, rid


def _chunk_repair(tables, phi_f, swarm_f, bank_f, regs_f, data_np,
                  full_C, K, W, n):
    """Per-chunk repair of a speculation-missed TDFA scan: walk the
    chunk chain exactly on host, decoding TRUSTED chunks (speculated
    entry == true entry; in-core exit for hot-core tables) from the
    kernel's per-chunk planes — their post-warmup register rebuilds
    are provably the true machine's (docs/TDFA_DESIGN.md
    "Certification soundness"), and any value still BAD-tainted
    (traces to the entry or the warmup) forces a host re-walk of that
    one chunk.  Returns (rid, bank) | None (certified no-match) |
    "fallback" when more than ~6% of chunks need host walks (the
    caller then prefers the multi-pass device path)."""
    t = tables.tdfa
    ncls = tables.ncls
    T = tables.ntags
    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    budget = max(32, full_C // 16)
    walked = 0
    sid = t.seed_state(CTX_BOS)
    regs = [0] * t.nregs(sid)
    bank = None
    rid = -1
    c = 0
    while c < full_C:
        dead = False
        kp = tables.to_kernel_premult(sid)
        # trusted only when the kernel's converged entry state equals
        # the true one AND the exit stayed in-core (an ESC exit's
        # planes are garbage past the escape point)
        exit_sid = tables.from_kernel_premult(int(phi_f[c])) \
            if kp is not None and int(swarm_f[c]) == kp else None
        if exit_sid is not None:
            nk = t.nregs(exit_sid)
            vals = [int(regs_f[k, c]) for k in range(nk)]
            crid = int(bank_f[T, c])
            bvals = [int(bank_f[ti, c]) for ti in range(T)] \
                if crid >= 0 else []
            if all(v >= -1 for v in vals) \
                    and all(v >= -1 for v in bvals):
                base = c * K - W
                regs = [v + base if v >= 0 else -1 for v in vals]
                if crid >= 0:
                    bank = [v + base if v >= 0 else -1 for v in bvals]
                    rid = crid
                sid = exit_sid
                dead = t.is_dead(sid)
                c += 1
                if dead:
                    break
                continue
        walked += 1
        if walked > budget:
            return "fallback"       # too many misses (None = no-match)
        sid, regs, bank, rid = _walk_chunk(
            t, sid, regs, bank, rid, raw, c * K, min((c + 1) * K, n))
        c += 1
        if t.is_dead(sid):
            break
    # finish: ragged tail (+ EOF boundary), or just the dead/EOF
    # resolution when the covered region completed
    return _host_walk(tables, sid, regs, bank, rid, data_np,
                      min(c * K, n), n)


def tdfa_find_many(tables, docs, chunk_len=2048, prepared=None):
    """Batched one-pass tagged find over a document SET: one kernel
    dispatch, per-document results — the capture analogue of
    ops/batch.py (document starts ride the per-chunk (state0, j0)
    planes exactly like chunk 0; every document folds independently
    through _chunk_repair, whose positions are document-local by
    construction).  Returns a list of (rid, bank) | None (certified
    no-match) | "fallback" per document; raises BatchUnsupported when
    no zero-class pad byte exists."""
    from .batch import batch_prepare, _pack_key
    docs = [d if isinstance(d, (bytes, bytearray)) else bytes(d)
            for d in docs]
    t = tables.tdfa
    W = tables.warmup

    def seed_entry():
        sid = t.seed_state(CTX_BOS)
        return sid, [0] * t.nregs(sid)

    if prepared is None or prepared._key != _pack_key(tables):
        prepared = batch_prepare(tables, docs, chunk_len)
    K, spans = prepared.K, prepared.spans
    data, C, Kp, J, B = prepared.prepared
    G = GROUPS
    R, T = tables.nregs, tables.ntags
    state0 = np.full((B, G * TILE), tables.seed_premult,
                     dtype=np.int32)
    j0 = np.zeros((B, G * TILE), dtype=np.int32)
    j0f = j0.reshape(-1)
    for c0, _, _ in spans:
        j0f[c0] = W

    _, phi_f, swarm_f, bank_f, regs_f = _tdfa_scan(
        data if isinstance(data, jax.Array) else jnp.asarray(data),
        jnp.asarray(state0.reshape(B, G, 8, 128)),
        jnp.asarray(j0.reshape(B, G, 8, 128)),
        tables.t_next, tables.t_regsrc, tables.t_csrc,
        tables.t_cmeta,
        jnp.int32(C), jnp.int32(tables.dead_premult),
        W=W, CPW=tables.cpw, BITS=tables.bits,
        CODE=tables.code_bits, R=R, T=T)
    # the whole-stream summary cannot serve per-document results;
    # every document folds through the chunk-repair walk (trusted
    # chunks decode from the planes, the rest re-walk natively)
    phi = np.asarray(phi_f)
    swarm = np.asarray(swarm_f)
    bank = np.asarray(bank_f)
    regs = np.asarray(regs_f)
    out = []
    for (c0, cd, n), doc in zip(spans, docs):
        if n == 0:
            sid, rg = seed_entry()
            out.append(_host_walk(tables, sid, rg, None, -1, doc,
                                  0, 0))
            continue
        full_C = cd if cd * K == n else cd - 1
        if full_C == 0:
            sid, rg = seed_entry()
            out.append(_host_walk(tables, sid, rg, None, -1, doc,
                                  0, n))
            continue
        try:
            r = _chunk_repair(tables, phi[c0:c0 + cd],
                              swarm[c0:c0 + cd],
                              bank[:, c0:c0 + cd],
                              regs[:, c0:c0 + cd],
                              doc, full_C, K, W, n)
        except TdfaTooLarge:
            r = "fallback"
        out.append(r)
    return out


def tdfa_spec_find(tables, data_np, chunk_len=2048, prepared=None):
    """First final match over the whole buffer: (regex_id, bank) with
    bank the tracked-tag vector in absolute corpus positions, None for
    no-match, or the string "fallback" when the device result cannot
    be certified exact (speculation miss, or a match span exceeding
    the chunk window).  Callers treat "fallback" by running the exact
    host/multi-pass path."""
    t = tables.tdfa
    n = len(data_np)
    W = tables.warmup

    def seed_entry():
        sid = t.seed_state(CTX_BOS)
        return sid, [0] * t.nregs(sid)

    if n == 0:
        sid, regs = seed_entry()
        return _host_walk(tables, sid, regs, None, -1, data_np, 0, 0)
    if prepared is None:
        prepared = _prepare(tables, data_np, chunk_len)
    data, C, K, J, B = prepared
    # ragged tail: the device covers only full chunks; the tail is
    # finished on host from the last covered exit state/registers
    full_C = C if C * K <= n else C - 1
    if full_C == 0:
        sid, regs = seed_entry()
        return _host_walk(tables, sid, regs, None, -1, data_np, 0, n)

    G = GROUPS
    R, T = tables.nregs, tables.ntags
    state0 = np.zeros((B, G * TILE), dtype=np.int32)
    j0 = np.zeros((B, G * TILE), dtype=np.int32)
    state0[:] = tables.seed_premult
    j0[0, 0] = W

    summary, phi_f, swarm_f, bank_f, regs_f = _tdfa_scan(
        data if isinstance(data, jax.Array) else jnp.asarray(data),
        jnp.asarray(state0.reshape(B, G, 8, 128)),
        jnp.asarray(j0.reshape(B, G, 8, 128)),
        tables.t_next, tables.t_regsrc, tables.t_csrc,
        tables.t_cmeta,
        jnp.int32(full_C), jnp.int32(tables.dead_premult),
        W=W, CPW=tables.cpw, BITS=tables.bits,
        CODE=tables.code_bits, R=R, T=T)
    summ = np.asarray(summary).astype(np.int64)
    if tables.is_core or not bool(summ[0]):
        # chunk-wise repair: validate the chain on host per chunk,
        # decoding trusted chunks from the per-chunk planes and
        # re-walking the rest on the host TDFA.  Bounded; None means
        # too many misses (caller falls back to the multi-pass path).
        # Core tables ALWAYS take this fold: the device chain cannot
        # distinguish a genuine validation from two streams meeting
        # at the ESC sink, so trust is decided host-side per chunk.
        # (A lazy full machine can exhaust max_states mid-walk —
        # that is a fallback, not an error.)
        try:
            r = _chunk_repair(tables, np.asarray(phi_f),
                              np.asarray(swarm_f), np.asarray(bank_f),
                              np.asarray(regs_f), data_np, full_C,
                              K, W, n)
        except TdfaTooLarge:
            return "fallback"
        return r                    # (rid,bank) | None | "fallback"

    dead_chunk, lc = int(summ[2]), int(summ[3])
    bank_vals = summ[10:10 + T + 1]
    exit_regs = summ[10 + T + 1:10 + T + 1 + R]
    ncls = tables.ncls

    def to_corpus(v, c):
        v = int(v)
        if v == -1:
            return -1
        if v < 0:
            return None          # BAD: span exceeded the window
        return v + c * K - W

    bank = None
    rid = -1
    if lc >= 0:
        rid = int(bank_vals[T])
        bank = [to_corpus(v, lc) for v in bank_vals[:T]]

    def repair():
        try:
            r = _chunk_repair(tables, np.asarray(phi_f),
                              np.asarray(swarm_f), np.asarray(bank_f),
                              np.asarray(regs_f), data_np, full_C,
                              K, W, n)
        except TdfaTooLarge:
            return "fallback"
        return r                    # (rid,bank) | None | "fallback"

    if dead_chunk < full_C:
        # the scan ended inside the covered region
        if bank is None:
            return None
        if any(b is None for b in bank):
            # winning bank traces past the chunk window (e.g. the
            # match starts before it): chunk-wise repair resolves it
            # without abandoning the device pass
            return repair()
        return rid, bank

    # no death in the covered region: host finishes the ragged tail
    # and the EOF boundary from the last covered exit state/registers
    sid = int(summ[4]) // ncls
    base = (full_C - 1) * K - W
    regs = []
    for k in range(min(t.nregs(sid), R)):
        v = int(exit_regs[k])
        regs.append(v + base if v >= 0 else (-1 if v == -1 else None))
    if bank is not None and any(b is None for b in bank):
        return repair()
    r = _host_walk(tables, sid, regs, bank, rid, data_np,
                   full_C * K, n)
    return repair() if r == "fallback" else r
