"""Dense host TDFA tables + ctypes bindings for the C++ walker
(csrc/sre_tdfa.cpp) — findall/finditer capture resolution at
table-walk speed instead of Pike thread simulation.

The Tdfa (sregex_tpu/tdfa.py) is materialized by BFS over byte
classes with host-sized budgets (far above the device kernel's
S*ncls <= 128); every transition's register ops and commit sources
are flattened into int8 arrays the walker consumes branch-free.

Semantics: exact mode (true leftmost-first; seeds take their context
from the actual predecessor byte) — identical to the exact-mode Pike
engines behind Scanner.finditer/sub (docs/CONFORMANCE.md quirks
#3/#4).  tests/test_native_tdfa.py fuzzes the equivalence.
"""

import ctypes
import threading

import numpy as np

from . import native_build
from .tdfa import Tdfa, TdfaTooLarge, SRC_UNSET, SRC_CUR, SRC_NEXT


_lock = threading.Lock()
_lib = None
_tried = False

# walker source codes (sre_tdfa.cpp must agree)
_C_UNSET = -1
_C_CUR = -2
_C_NEXT = -3

# budgets: bound table memory (S*ncls*(R+T) bytes) and the
# materialization time (one Pike-step simulation per transition)
MAX_STATES = 768
MAX_REGS = 32
MAX_TAGS = 64
MAX_ENTRIES = 1 << 15        # S * ncls


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = native_build.load(
                "sre_tdfa.cpp", [["-O3", "-march=native", "-shared", "-fPIC"]])
        except Exception:
            return None
        i8p = ctypes.POINTER(ctypes.c_int8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.sre_tdfa_create.restype = ctypes.c_void_p
        lib.sre_tdfa_create.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            i32p, i8p, i16p, i8p, i16p, i8p, u8p, i8p, i32p, u8p,
            i32p]
        lib.sre_tdfa_destroy.restype = None
        lib.sre_tdfa_destroy.argtypes = [ctypes.c_void_p]
        lib.sre_tdfa_findall.restype = ctypes.c_int64
        lib.sre_tdfa_findall.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, i64p, ctypes.c_int64]
        _lib = lib
        return _lib


def _code(src):
    if src == SRC_UNSET:
        return _C_UNSET
    if src == SRC_CUR:
        return _C_CUR
    if src == SRC_NEXT:
        return _C_NEXT
    return src


class NativeTdfa:
    """Materialized TDFA + C++ walker handle.

    findall(data, ...) -> int64 array [m, 1 + T]: regex id then the
    full tag vector (absolute positions) per match, in re-arm order.
    Raises TdfaTooLarge when the automaton exceeds the host budgets
    (callers fall back to the Pike loop)."""

    def __init__(self, prog, max_states=MAX_STATES):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native tdfa walker unavailable")
        self.lib = lib
        self.program = prog
        if prog.ovecsize > MAX_TAGS:
            raise TdfaTooLarge("too many tags (%d)" % prog.ovecsize)
        t = Tdfa(prog, max_states=max_states, max_regs=MAX_REGS)
        ncls = t.nclasses

        # materialize every reachable state (transitions are lazy)
        i = 0
        while i < t.nstates:
            for c in range(ncls):
                t.step(i, c)
                if t.nstates * ncls > MAX_ENTRIES:
                    raise TdfaTooLarge(
                        "TDFA too large for the host walker "
                        "(S*ncls > %d)" % MAX_ENTRIES)
            t.eof_step(i)
            i += 1

        S = t.nstates
        self.tdfa = t
        T = prog.ovecsize
        Rmax = max(t.nregs(s) for s in range(S)) if S else 1
        Rmax = max(Rmax, 1)
        self.S, self.ncls, self.T, self.Rmax = S, ncls, T, Rmax

        next_sid = np.zeros(S * ncls, np.int32)
        op_src = np.full((S * ncls, Rmax), _C_UNSET, np.int8)
        commit_rid = np.full(S * ncls, -1, np.int16)
        commit_src = np.full((S * ncls, T), _C_UNSET, np.int8)
        eof_rid = np.full(S, -1, np.int16)
        eof_src = np.full((S, T), _C_UNSET, np.int8)
        dead = np.zeros(S, np.uint8)
        nregs = np.zeros(S, np.int8)
        for s in range(S):
            dead[s] = 1 if t.is_dead(s) else 0
            nregs[s] = t.nregs(s)
            m = t.eof_step(s)
            if m is not None:
                srcs, rid = m
                eof_rid[s] = rid
                for ti, src in enumerate(srcs):
                    eof_src[s, ti] = _code(src)
            for c in range(ncls):
                nsid, ops, commit = t.step(s, c)
                idx = s * ncls + c
                next_sid[idx] = nsid
                for d, src in ops:
                    op_src[idx, d] = _code(src)
                if commit is not None:
                    srcs, rid = commit
                    commit_rid[idx] = rid
                    for ti, src in enumerate(srcs):
                        commit_src[idx, ti] = _code(src)

        seed_sid = np.array([t.seed_state(ctx) for ctx in range(5)],
                            np.int32)
        class_map = t.class_map.astype(np.uint8)
        slice_ofs = np.array(t.slice_ofs, np.int32)

        def p(a, ct):
            return a.ctypes.data_as(ctypes.POINTER(ct))

        self.handle = lib.sre_tdfa_create(
            S, ncls, Rmax, T, prog.nregexes,
            p(next_sid, ctypes.c_int32),
            p(np.ascontiguousarray(op_src), ctypes.c_int8),
            p(commit_rid, ctypes.c_int16),
            p(np.ascontiguousarray(commit_src), ctypes.c_int8),
            p(eof_rid, ctypes.c_int16),
            p(np.ascontiguousarray(eof_src), ctypes.c_int8),
            p(dead, ctypes.c_uint8), p(nregs.view(np.int8),
                                       ctypes.c_int8),
            p(seed_sid, ctypes.c_int32), p(class_map, ctypes.c_uint8),
            p(slice_ofs, ctypes.c_int32))

    def __del__(self):
        try:
            self.lib.sre_tdfa_destroy(self.handle)
        except Exception:
            pass

    def _batches(self, data, start_pos=0, empty_skip=False,
                 batch=256, max_batch=1 << 16):
        """Yield int64 arrays [m, 1 + T] of successive matches (the
        C walker's resume protocol); batch sizes grow geometrically
        so early-exit callers don't pay for the whole corpus."""
        buf = np.frombuffer(data, dtype=np.uint8) if len(data) else \
            np.zeros(0, dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        pos = start_pos
        skip = 1 if empty_skip else 0
        while True:
            out = np.empty((batch, 1 + self.T), np.int64)
            m = self.lib.sre_tdfa_findall(
                self.handle, buf.ctypes.data_as(u8p), len(buf),
                pos, skip, out.ctypes.data_as(i64p), batch)
            if m:
                yield out[:m]
            if m < batch:
                return
            last = out[m - 1]
            rid = int(last[0])
            ofs = self.tdfa.slice_ofs[rid]
            s, e = int(last[1 + ofs]), int(last[1 + ofs + 1])
            if s == e and e >= len(buf):
                return
            pos = e
            skip = 1 if s == e else 0
            batch = min(batch * 4, max_batch)

    def findall(self, data, start_pos=0, empty_skip=False,
                batch=1 << 16):
        """All matches of data[start_pos:] as an int64 array
        [m, 1 + T] (regex id, tag vector) in re-arm order."""
        chunks = [c.copy() for c in self._batches(
            data, start_pos, empty_skip, batch=batch)]
        if not chunks:
            return np.empty((0, 1 + self.T), np.int64)
        return np.concatenate(chunks, axis=0)

    def iter_ovectors(self, data):
        """Yield (regex_id, ovector) per match with the Scanner
        layout (matched regex's slice first, -1 fill) — the
        prepare_matched_captures format (sre_vm_pike.c:945-989)."""
        prog = self.program
        ovecsize = prog.ovecsize
        for rows in self._batches(data):
            for row in rows:
                rid = int(row[0])
                ofs = self.tdfa.slice_ofs[rid]
                ns = 2 * (prog.multi_ncaps[rid] + 1)
                ov = [int(v) for v in row[1 + ofs:1 + ofs + ns]]
                ov += [-1] * (ovecsize - ns)
                yield rid, ov
