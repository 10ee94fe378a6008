"""Pair-step kernel tier (ops/pallas_pair.py) vs the byte kernels and
the native engine — same results for scan/count under arbitrary
corpora, entry states, and ragged tails (the plain walk on the CPU)."""

import numpy as np
import pytest

from sregex_tpu.parser import parse, parse_multi
from sregex_tpu.compiler import compile_regex
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops.pallas_pair import SpecTablesPair
from sregex_tpu.ops.pallas_scan import (SpecTables, spec_scan_bytes,
                                        spec_count_bytes)


def make(pat):
    if isinstance(pat, list):
        ast, _ = parse_multi(pat, [0] * len(pat))
    else:
        ast, _ = parse(pat, 0)
    return build_dfa(compile_regex(ast))


BENCH = b'(?:a|b)aa(?:aa|bb)cc(?:a|b)'


@pytest.mark.parametrize("pat,alpha", [
    (BENCH, b"abc."),
    (b"abc", b"abcx"),
    (rb"a+b", b"ab."),
    (rb"\bword\b", b"word x"),
    ([b"foo", rb"b[ar]+"], b"fobar "),
])
def test_pair_equals_byte_and_native(pat, alpha):
    dfa = make(pat)
    tp = SpecTablesPair(dfa)
    nd = NativeDfa(dfa)
    rng = np.random.default_rng(hash(str(pat)) & 0xffff)
    for n in (0, 1, 63, 2048, 5000, 16384, 20000):
        data = bytes(rng.choice(np.frombuffer(alpha, np.uint8),
                                size=n)) if n else b""
        fp, statep = None, None
        sp, fp = spec_scan_bytes(tp, data, chunk_len=512)
        fn, sn = nd.scan_first(data, 0)
        assert (fp, sp) == (fn, sn), (pat, n, "scan")
        sp, cp = spec_count_bytes(tp, data, chunk_len=512)
        cn, sn = nd.count(data, 0)
        assert (cp, sp) == (cn, sn), (pat, n, "count")


def test_pair_entry_state_carry():
    dfa = make(rb"ab+c")
    tp = SpecTablesPair(dfa)
    nd = NativeDfa(dfa)
    rng = np.random.default_rng(3)
    data = bytes(rng.choice(np.frombuffer(b"abc.", np.uint8),
                            size=6000))
    for entry in range(dfa.nstates):
        sp, fp = spec_scan_bytes(tp, data, chunk_len=512,
                                 entry_state=entry)
        fn, sn = nd.scan_first(data, entry)
        assert (fp, sp) == (fn, sn), entry


def test_pair_matches_narrow_tables():
    # a pattern small enough for both tiers: byte narrow vs pair
    dfa = make(b"abc")
    tn = SpecTables(dfa)
    tp = SpecTablesPair(dfa)
    rng = np.random.default_rng(9)
    data = bytes(rng.choice(np.frombuffer(b"abcx", np.uint8),
                            size=30000))
    assert spec_scan_bytes(tn, data) == spec_scan_bytes(tp, data)
    assert spec_count_bytes(tn, data) == spec_count_bytes(tp, data)


def test_pair_boundary_straddle():
    # matches straddling chunk boundaries at every parity
    dfa = make(rb"xyz")
    tp = SpecTablesPair(dfa)
    nd = NativeDfa(dfa)
    base = bytearray(b"." * 4096)
    for pos in (509, 510, 511, 512, 513, 1022, 1023, 1024, 2047):
        data = bytes(base[:pos] + b"xyz" + base[pos + 3:])
        sp, fp = spec_scan_bytes(tp, data, chunk_len=512)
        fn, sn = nd.scan_first(data, 0)
        assert (fp, sp) == (fn, sn), pos


def test_pair_count_two_boundaries_in_one_pair():
    # both bytes of one pair end a match: the 2-bit count field must
    # record 2 (pattern a matches at every 'a')
    dfa = make(b"a")
    tp = SpecTablesPair(dfa)
    nd = NativeDfa(dfa)
    data = b"aa" * 3000 + b"xaa"
    sp, cp = spec_count_bytes(tp, data, chunk_len=512)
    cn, sn = nd.count(data, 0)
    assert (cp, sp) == (cn, sn)


def test_pair_budget_rejection():
    big = make(rb"(?:ab|aab){30,60}z")
    with pytest.raises(ValueError):
        SpecTablesPair(big)
