"""Big-table speculative tier (ops/pallas_big.py) vs the host DFA
engine, on the CPU mesh (the plain walk; tests/test_scan_kernel.py
checks the GPU kernel body against it).

Patterns chosen to cross every tier boundary: S*ncls > 1024 (past the
wide kernel), ncls > 16 (8-bit class packing), and the
counted-repetition chains that are the reason big tables exist."""

import random

import numpy as np
import pytest

from sregex_tpu import parse, compile_regex
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops.pallas_big import SpecTablesBig
from sregex_tpu.ops.pallas_scan import (spec_scan_bytes,
                                        spec_count_bytes,
                                        spec_scan_last_bytes)

CASES = [
    # (pattern, alphabet, planted)
    (b"word (?:[a-zA-Z0-9]+ ){0,10}otherword",
     b"word other abc12 ", b"word abc de3 otherword"),
    # (context-conditional byte classes shrank small counted reps
    # below the narrow cap, so the chain must be longer to stay big)
    (b"a{60,120}b", b"aab", b"x" + b"a" * 80 + b"b"),
    (b"(x|y|z[QW]){1,5}(longish|loquatious)",
     b"xyzQWlongishloquatious", b"zQxylongish"),
    (b"^.{9}abc.*\n", b"abc\nxyzw", b"123456789abczz\n"),
]


def _tables(pattern):
    ast, _ = parse(pattern)
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    return dfa, SpecTablesBig(dfa), NativeDfa(dfa)


@pytest.mark.parametrize("pattern,alphabet,planted", CASES)
def test_big_scan_matches_native(pattern, alphabet, planted):
    dfa, tables, native = _tables(pattern)
    assert dfa.nstates * dfa.nclasses > 128  # genuinely past narrow
    rng = random.Random(len(pattern))
    for trial in range(3):
        n = rng.choice([300, 900, 2500])
        data = bytes(rng.choice(alphabet) for _ in range(n))
        if trial != 1:
            mid = n // 2
            data = data[:mid] + planted + data[mid:]
        exp_first, exp_state = native.scan_first(data, 0)
        got_state, got_first = spec_scan_bytes(tables, data,
                                               chunk_len=256)
        assert got_first == exp_first, \
            "%r: first %r != %r" % (pattern, got_first, exp_first)
        if exp_first < 0:
            assert got_state == exp_state
        else:
            assert got_state == exp_state  # boundary state contract


@pytest.mark.parametrize("pattern,alphabet,planted", CASES[:2])
def test_big_count_matches_native(pattern, alphabet, planted):
    dfa, tables, native = _tables(pattern)
    rng = random.Random(7 + len(pattern))
    data = (planted + bytes(rng.choice(alphabet) for _ in range(700))
            + planted)
    exp, exp_st = native.count(data, 0)
    st, got = spec_count_bytes(tables, data, chunk_len=256)
    assert got == exp, (got, exp)
    assert st == exp_st


def test_big_scan_last_matches_native():
    pattern, alphabet, planted = CASES[1]
    dfa, tables, native = _tables(pattern)
    rng = random.Random(3)
    data = (bytes(rng.choice(alphabet) for _ in range(400))
            + planted + b"xx" + planted)
    exp_last, exp_st = native.scan_last(data, 0)
    st, got = spec_scan_last_bytes(tables, data, chunk_len=256)
    assert got == exp_last, (got, exp_last)
    assert st == exp_st


def test_big_rejects_oversize():
    from sregex_tpu.ops.pallas_big import MAX_ENTRIES
    # synthetic: don't build a >128K-entry DFA, just check the guard
    class FakeDfa:
        nstates = MAX_ENTRIES
        nclasses = 2
    with pytest.raises(ValueError):
        SpecTablesBig(FakeDfa())


def test_eight_bit_packing_selected():
    ast, _ = parse(CASES[2][0])
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    t = SpecTablesBig(dfa)
    if dfa.nclasses > 16:
        assert t.bits == 8 and t.cpw == 4
    else:
        assert t.bits == 4 and t.cpw == 8
