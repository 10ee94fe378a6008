"""Speculative chunk scan vs host DFA engine (the plain walk on the
CPU mesh; tests/test_scan_kernel.py checks the GPU kernel body
against it in interpret mode)."""

import random

import numpy as np
import pytest

from sregex_tpu import parse, compile_regex
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa

from sregex_tpu.ops.pallas_scan import SpecTables, spec_scan_bytes

PATTERNS = [
    "(?:a|b)aa(?:aa|bb)cc(?:a|b)",
    "abc",
    "a+b",
    r"\bword\b",
    "^line",
    r"tail\z",
]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_spec_scan_matches_native(pattern):
    ast, _ = parse(pattern)
    dfa = build_dfa(compile_regex(ast))
    tables = SpecTables(dfa)
    native = NativeDfa(dfa)
    rng = random.Random(hash(pattern) & 0xFFFF)
    alphabet = b"abcwordline tail\nxyz"
    for trial in range(4):
        n = rng.choice([100, 1000, 5000])
        data = bytes(rng.choice(alphabet) for _ in range(n))
        if trial == 2:
            mid = n // 2
            data = data[:mid] + b" abcaaabbccab word tail" + data[mid:]
        exp_first, exp_state = native.scan_first(data, 0)
        got_state, got_first = spec_scan_bytes(tables, data,
                                               chunk_len=256)
        assert got_first == exp_first, \
            "%r: first %r != %r" % (pattern, got_first, exp_first)
        if exp_first < 0:
            assert got_state == exp_state


def test_spec_tables_reject_large():
    # a pattern whose S*ncls exceeds one lane row
    ast, _ = parse("(abc|def|ghi|jkl|mno|pqr)(stu|vwx)[0-9]{4}")
    dfa = build_dfa(compile_regex(ast))
    if dfa.nstates * dfa.nclasses > 128:
        with pytest.raises(ValueError):
            SpecTables(dfa)


def test_spec_count_matches_native():
    from sregex_tpu.ops.pallas_scan import spec_count_bytes
    ast, _ = parse("ab")
    dfa = build_dfa(compile_regex(ast))
    tables = SpecTables(dfa)
    native = NativeDfa(dfa)
    rng = random.Random(7)
    data = bytes(rng.choice(b"aabbc") for _ in range(5000))
    exp, _st = native.count(data, 0)
    st, got = spec_count_bytes(tables, data, chunk_len=240)
    assert got == exp, (got, exp)
    _, st2 = native.count(data, 0)
    assert st == st2


def test_spec_count_exact_multiple_length():
    # corpus length an exact multiple of chunk_len: no ragged tail, so
    # the all-valid fast path (device prefix sum) is what returns
    from sregex_tpu.ops.pallas_scan import spec_count_bytes
    ast, _ = parse("ab")
    dfa = build_dfa(compile_regex(ast))
    tables = SpecTables(dfa)
    native = NativeDfa(dfa)
    data = (b"ab" * 120)  # 240 = one full chunk at chunk_len=240
    # chunk_len quantized to 240 for 4-bit packing (CPW*WPI=16 -> 240)
    exp, _ = native.count(data, 0)
    st, got = spec_count_bytes(tables, data, chunk_len=240)
    assert got == exp, (got, exp)


def test_spec_scan_last_matches_native():
    from sregex_tpu.ops.pallas_scan import spec_scan_last_bytes
    ast, _ = parse("ab")
    dfa = build_dfa(compile_regex(ast))
    tables = SpecTables(dfa)
    native = NativeDfa(dfa)
    rng = random.Random(11)
    for n in (100, 3000, 4800):
        data = bytes(rng.choice(b"aabbc") for _ in range(n))
        exp, est = native.scan_last(data, 0)
        st, got = spec_scan_last_bytes(tables, data, chunk_len=240)
        assert got == exp, (n, got, exp)
        assert st == est


def test_wide_tables_match_native():
    from sregex_tpu.ops.pallas_scan import (SpecTablesWide,
                                            spec_scan_bytes,
                                            spec_count_bytes,
                                            spec_scan_last_bytes)
    # an automaton too large for the narrow table (long counted run:
    # ~62 states, 3 byte classes)
    pat = "a{60}b"
    ast, _ = parse(pat)
    dfa = build_dfa(compile_regex(ast))
    assert dfa.nstates * dfa.nclasses > 128
    with pytest.raises(ValueError):
        SpecTables(dfa)
    tables = SpecTablesWide(dfa)
    native = NativeDfa(dfa)
    rng = random.Random(3)
    alphabet = b"aaaaaaab "
    for trial in range(4):
        data = bytes(rng.choice(alphabet) for _ in range(3000))
        if trial >= 2:
            mid = 1000 + trial
            data = data[:mid] + b"c" + b"a" * 60 + b"b" + data[mid:]
        exp_first, est = native.scan_first(data, 0)
        st, got = spec_scan_bytes(tables, data, chunk_len=240)
        assert got == exp_first, (trial, got, exp_first)
        exp_cnt, ecst = native.count(data, 0)
        cst, cnt = spec_count_bytes(tables, data, chunk_len=240)
        assert cnt == exp_cnt and cst == ecst
        exp_last, elst = native.scan_last(data, 0)
        lst, last = spec_scan_last_bytes(tables, data, chunk_len=240)
        assert last == exp_last and lst == elst


def test_wide_tier_r17_matches_native():
    """Extended wide tier (1024 < S*ncls <= 4096 table entries)."""
    from sregex_tpu.ops.pallas_scan import SpecTablesWide
    ast, _ = parse("word (?:[a-zA-Z0-9]+ ){0,10}otherword")
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    assert 1024 < dfa.nstates * dfa.nclasses <= 4096
    tables = SpecTablesWide(dfa)
    assert tables.rows > 8
    native = NativeDfa(dfa)
    rng = random.Random(17)
    for trial in range(2):
        n = 3000
        data = bytes(rng.choice(b"word other ab1 ") for _ in range(n))
        if trial == 0:
            data = data[:1500] + b"word ab c1 otherword" + data[1500:]
        exp_first, exp_state = native.scan_first(data, 0)
        got_state, got_first = spec_scan_bytes(tables, data,
                                               chunk_len=256)
        assert (got_first, got_state) == (exp_first, exp_state)


def test_chunk_clamp_keeps_counts_in_16_bits():
    """The chunk clamp is the repair planes' 16-bit per-chunk count
    bound: the largest chunk on the packing quantum below 2**16, for
    every packing and unit width."""
    from sregex_tpu.ops.pallas_scan import (max_chunk_bytes,
                                            WORDS_PER_ITER)
    for cpw, bpu in [(4, 1), (8, 1), (10, 1), (4, 2), (8, 2)]:
        k = max_chunk_bytes(cpw, bpu=bpu)
        quantum = cpw * WORDS_PER_ITER * bpu
        assert k % quantum == 0 and k < 1 << 16, (cpw, bpu, k)
        assert k + quantum >= 1 << 16, (cpw, bpu, k)


def test_wide_tables_carry_derived_clamp():
    """Every 8-bit tier object exposes a max_chunk that
    effective_chunk honors (no constant clamps anywhere)."""
    from sregex_tpu import parse_multi
    from sregex_tpu.ops.pallas_scan import (SpecTablesWide,
                                            effective_chunk,
                                            max_chunk_bytes)
    rng = random.Random(7)
    words = ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                     for _ in range(4)) for _ in range(18)]
    ast, _ = parse_multi(words)
    dfa = build_dfa(compile_regex(ast))
    t = SpecTablesWide(dfa)
    assert t.bits == 8
    assert t.max_chunk == max_chunk_bytes(t.cpw)
    assert effective_chunk(t, 1 << 15) <= t.max_chunk
    assert effective_chunk(t, 1 << 20) == t.max_chunk
