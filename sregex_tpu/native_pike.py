"""ctypes bindings for the native C++ streaming Pike VM
(csrc/sre_pike.cpp) — the production host engine.

Exposes the same exec protocol as the Python PikeCtx
(sregex_tpu/pike_vm.py); programs are serialized once to flat arrays.
Falls back to the Python engine when no compiler is available
(NativePikeCtx.available()).
"""

import ctypes
import threading

import numpy as np

from . import native_build
from .consts import (OP_IN, OP_NOTIN, OP_CHAR, OP_SAVE, OP_ASSERT,
                     OP_MATCH)


_lock = threading.Lock()
_lib = None
_tried = False


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = native_build.load(
                "sre_pike.cpp", [["-O3", "-march=native", "-shared", "-fPIC"]])
        except Exception:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.sre_pike_prog_create.restype = ctypes.c_void_p
        lib.sre_pike_prog_create.argtypes = [
            ctypes.c_int32, i32p, i32p, i32p, i32p, i32p, i32p,
            u8p, u8p, ctypes.c_int32, ctypes.c_int32, i32p,
            ctypes.c_int32, ctypes.c_int32, u8p]
        lib.sre_pike_prog_destroy.restype = None
        lib.sre_pike_prog_destroy.argtypes = [ctypes.c_void_p]
        lib.sre_pike_ctx_create.restype = ctypes.c_void_p
        lib.sre_pike_ctx_create.argtypes = [ctypes.c_void_p, i64p,
                                            ctypes.c_int32]
        lib.sre_pike_ctx_destroy.restype = None
        lib.sre_pike_ctx_destroy.argtypes = [ctypes.c_void_p]
        lib.sre_pike_ctx_set_exact.restype = None
        lib.sre_pike_ctx_set_exact.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int32]
        lib.sre_pike_ctx_set_carry.restype = None
        lib.sre_pike_ctx_set_carry.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32]
        lib.sre_pike_exec.restype = ctypes.c_int64
        lib.sre_pike_exec.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, i64p, i32p]
        _lib = lib
        return _lib


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeProgram:
    """Serialized program handle for the C++ engine."""

    def __init__(self, prog):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native pike engine unavailable")
        self.lib = lib
        self.program = prog
        n = len(prog.insts)
        opcode = np.zeros(n, np.int32)
        x = np.zeros(n, np.int32)
        y = np.zeros(n, np.int32)
        val = np.zeros(n, np.int32)
        rofs = np.zeros(n, np.int32)
        rcnt = np.zeros(n, np.int32)
        lo_list = []
        hi_list = []
        for i, ins in enumerate(prog.insts):
            opcode[i] = ins.opcode
            x[i] = ins.x
            y[i] = ins.y
            if ins.opcode == OP_CHAR:
                val[i] = ins.ch
            elif ins.opcode == OP_SAVE:
                val[i] = ins.group
            elif ins.opcode == OP_ASSERT:
                val[i] = ins.assertion
            elif ins.opcode == OP_MATCH:
                val[i] = ins.regex_id
            if ins.opcode in (OP_IN, OP_NOTIN):
                rofs[i] = len(lo_list)
                rcnt[i] = len(ins.ranges)
                for f, t in ins.ranges:
                    lo_list.append(f)
                    hi_list.append(t)
        lo = np.array(lo_list or [0], np.uint8)
        hi = np.array(hi_list or [0], np.uint8)
        ncaps = np.array(prog.multi_ncaps, np.int32)

        accept = None
        accept_ptr = None
        if prog.leading_bytes:
            accept = np.zeros(256, np.uint8)
            for idx in prog.leading_bytes:
                ins = prog.insts[idx]
                if ins.opcode == OP_CHAR:
                    accept[ins.ch] = 1
                elif ins.opcode == OP_IN:
                    for f, t in ins.ranges:
                        accept[f:t + 1] = 1
                elif ins.opcode == OP_NOTIN:
                    m = np.zeros(256, np.uint8)
                    for f, t in ins.ranges:
                        m[f:t + 1] = 1
                    accept |= (1 - m)
            accept_ptr = _u8(accept)

        self._keep = (opcode, x, y, val, rofs, rcnt, lo, hi, ncaps,
                      accept)
        self.handle = lib.sre_pike_prog_create(
            n, _i32(opcode), _i32(x), _i32(y), _i32(val), _i32(rofs),
            _i32(rcnt), _u8(lo), _u8(hi), len(lo_list),
            prog.nregexes, _i32(ncaps), prog.ovecsize,
            prog.leading_byte, accept_ptr)

    def __del__(self):
        try:
            self.lib.sre_pike_prog_destroy(self.handle)
        except Exception:
            pass


class NativePikeCtx:
    """Streaming context over the C++ engine; drop-in for PikeCtx
    (same exec signature and ovector semantics)."""

    @staticmethod
    def available():
        return get_lib() is not None

    def __init__(self, nprog, ovector=None, ovecsize=None,
                 exact=False):
        if isinstance(nprog, NativeProgram):
            self.nprog = nprog
        else:
            self.nprog = NativeProgram(nprog)
        prog = self.nprog.program
        if ovecsize is None:
            ovecsize = prog.ovecsize if ovector is None else len(ovector)
        self._ovec = np.full(ovecsize, -1, dtype=np.int64)
        self.ovector = self._ovec  # numpy view; CLI copies out
        self.ovecsize = ovecsize
        self._pending = np.zeros(2, dtype=np.int64)
        self._pending_flag = np.zeros(1, dtype=np.int32)
        self.handle = self.nprog.lib.sre_pike_ctx_create(
            self.nprog.handle,
            self._ovec.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ovecsize)
        if exact:
            self.nprog.lib.sre_pike_ctx_set_exact(self.handle, 1)

    def set_carry(self, processed_bytes, seen_newline, seen_word):
        """Enter a stream mid-corpus: absolute position plus the
        newline/word context of the preceding byte."""
        self.nprog.lib.sre_pike_ctx_set_carry(
            self.handle, processed_bytes, 1 if seen_newline else 0,
            1 if seen_word else 0)

    def exec(self, input_, eof, want_pending=False):
        if input_ is None:
            input_ = b""
        buf = np.frombuffer(input_, dtype=np.uint8) if input_ else \
            np.zeros(0, dtype=np.uint8)
        rc = self.nprog.lib.sre_pike_exec(
            self.handle, _u8(buf), len(buf), 1 if eof else 0,
            1 if want_pending else 0,
            self._pending.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)),
            self._pending_flag.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)))
        pending = None
        if want_pending and self._pending_flag[0]:
            pending = [int(self._pending[0]), int(self._pending[1])]
        return int(rc), pending

    def __del__(self):
        try:
            self.nprog.lib.sre_pike_ctx_destroy(self.handle)
        except Exception:
            pass
