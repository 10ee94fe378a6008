"""Exact transfer-composition tier (ops/pallas_phi.py) vs the native
oracle, and the Scanner's auto-activation for never-converging
machines (the plain walk on the CPU mesh)."""

import os
import random

import pytest

from sregex_tpu import parse, compile_regex
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops.pallas_phi import (PhiTables, phi_count_bytes,
                                       phi_scan_bytes, _phi_prepare)
from sregex_tpu.stream import Scanner

CASES = [
    # (pattern, alphabet)
    (rb"\A(?:aa)*b", b"ab"),
    (rb"b(?:aa)*b", b"aab"),    # run-parity: unbounded history
    (rb"a{60,120}b", b"ab x"),
    (rb"(?:cat|dog)", b"catdog x"),
    (rb"\bw\d+\b", b"w12 xy"),
]


def _tables(pat):
    ast, _ = parse(pat)
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    return PhiTables(dfa), NativeDfa(dfa)


@pytest.mark.parametrize("pat,alpha", CASES,
                         ids=[repr(p) for p, _ in CASES])
def test_phi_count_and_scan_exact(pat, alpha):
    t, native = _tables(pat)
    rng = random.Random(7)
    for n, entry in [(300_000, 0), (4096, 2), (63, 0), (0, 0),
                     (2049, 1)]:
        entry = entry % max(1, t.nstates)
        data = bytes(rng.choice(alpha) for _ in range(n))
        assert phi_count_bytes(t, data, chunk_len=512,
                               entry_state=entry) \
            == native.count(data, entry)[::-1]
        exp_f, exp_st = native.scan_first(data, entry)
        st, f = phi_scan_bytes(t, data, chunk_len=512,
                               entry_state=entry)
        assert (f, st) == (exp_f, exp_st), (pat, n)


def test_phi_8bit_wide_alphabet():
    """17..256 byte classes ride 8-bit data words (multi-regex
    fusions: each distinct literal byte is its own class).  Same
    exactness contract as the 4-bit path."""
    from sregex_tpu import parse_multi
    pats = [bytes([c]) + b"q" for c in b"abcdefghijklmnopr"]
    pats.append(rb"b(?:aa)*b")      # keep parity structure in the mix
    ast, _ = parse_multi(pats)
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    t = PhiTables(dfa)
    assert t.bits == 8 and t.ncls > 16, (t.ncls, t.nstates)
    native = NativeDfa(dfa)
    rng = random.Random(11)
    alpha = b"abcdefghijklmnopqr x"
    for n, entry in [(200_000, 0), (4096, 1), (63, 0), (513, 2)]:
        entry = entry % t.nstates
        data = bytes(rng.choice(alpha) for _ in range(n))
        assert phi_count_bytes(t, data, chunk_len=512,
                               entry_state=entry) \
            == native.count(data, entry)[::-1]
        exp_f, exp_st = native.scan_first(data, entry)
        st, f = phi_scan_bytes(t, data, chunk_len=512,
                               entry_state=entry)
        assert (f, st) == (exp_f, exp_st), (n, entry)


def test_phi_prepared_reuse():
    t, native = _tables(rb"\A(?:aa)*b")
    rng = random.Random(9)
    data = bytes(rng.choice(b"ab") for _ in range(100_000))
    prep = _phi_prepare(t, data, 512)
    for _ in range(2):
        assert phi_count_bytes(t, data, chunk_len=512,
                               prepared=prep) \
            == native.count(data, 0)[::-1]


def test_phi_segment_packing_small_machine():
    """A tiny (S=3) machine folds exactly across every chunk count,
    including counts on both sides of the chunk-pad granularity (pad
    chunks compose as identity transfers)."""
    from sregex_tpu.ops.pallas_phi import _CHUNK_PAD
    t, native = _tables(rb"ab")
    assert t.nstates <= 4
    rng = random.Random(5)
    edge = _CHUNK_PAD * 512
    for n in (511, 512, 513, 50_000, 130_001, edge, edge + 512):
        data = bytes(rng.choice(b"aabx ") for _ in range(n))
        assert phi_count_bytes(t, data, chunk_len=512) \
            == native.count(data, 0)[::-1]


def test_scanner_escalates_to_phi_on_parity_machine():
    """Run-parity machines (b(?:aa)*b: the state tracks the a-run's
    parity since the last anchor, mod-2 — UNBOUNDED history) defeat
    every warmup window on long-run corpora; after the strike pairs
    exhaust the ladder the Scanner activates the φ tier and the same
    corpus scans exactly with zero repairs."""
    os.environ["SREGEX_CORE"] = "0"
    try:
        ast, _ = parse(rb"b(?:aa)*b")
        prog = compile_regex(ast)
        sc = Scanner(prog, use_device=True, ast=ast)
        sc.DEVICE_THRESHOLD = 1 << 12
        native = NativeDfa(sc.dfa)
        rng = random.Random(3)
        data = bytearray()
        while len(data) < 300_000:
            data += b"a" * rng.randrange(60, 300) + b"b"
        data = bytes(data[:300_000])
        exp_c, exp_st = native.count(data, 0)
        exp = exp_c + int(sc.dfa.match_eof[exp_st])
        seen_tiers = []
        for _ in range(8):
            assert sc.count(data) == exp
            seen_tiers.append(sc.stats().tier)
            if getattr(sc, "_phi_active", False):
                break
        assert getattr(sc, "_phi_active", False), seen_tiers
        assert sc.count(data) == exp
        st = sc.stats()
        assert st.tier == "PhiTables", st.as_dict()
        assert st.repaired == 0 and st.chunks > 0
        # scan path rides φ too
        exp_scan = sc.scan(data)
        sc_host = Scanner(prog, use_device=False, ast=ast)
        assert exp_scan == sc_host.scan(data)
    finally:
        os.environ.pop("SREGEX_CORE", None)


BIG_CASES = [
    # (pattern, alphabet): S in (128, 1024] with unbounded history
    (rb"b(?:a{137})*b", b"a" * 12 + b"ab"),
    (rb"x(?:a{300})*y", b"a" * 12 + b"axy"),
]


def _big_tables(pat):
    from sregex_tpu.ops.pallas_phi import PhiTablesBig
    ast, _ = parse(pat)
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    return PhiTablesBig(dfa), NativeDfa(dfa)


@pytest.mark.parametrize("pat,alpha", BIG_CASES,
                         ids=[repr(p) for p, _ in BIG_CASES])
def test_phi_big_count_and_scan_exact(pat, alpha):
    """Sublane-group φ kernel (128 < S <= 1024) vs the native oracle
    on speculation-hostile corpora (long a-runs)."""
    t, native = _big_tables(pat)
    assert t.nstates > 128, t.nstates
    rng = random.Random(9)
    for n, entry in [(200_000, 0), (4096, 5), (200, 0), (0, 0),
                     (2049, 77)]:
        entry = entry % max(1, t.nstates)
        data = bytes(rng.choice(alpha) for _ in range(n))
        assert phi_count_bytes(t, data, chunk_len=512,
                               entry_state=entry) \
            == native.count(data, entry)[::-1]
        exp_f, exp_st = native.scan_first(data, entry)
        st, f = phi_scan_bytes(t, data, chunk_len=512,
                               entry_state=entry)
        assert (f, st) == (exp_f, exp_st), (pat, n)


def test_phi_big_prepared_reuse():
    from sregex_tpu.ops.pallas_phi import phi_prepare
    t, native = _big_tables(rb"b(?:a{137})*b")
    rng = random.Random(3)
    data = bytes(rng.choice(b"aaab") for _ in range(50_000))
    prep = phi_prepare(t, data, 512)
    a = phi_count_bytes(t, data, chunk_len=512, prepared=prep)
    b = phi_count_bytes(t, data, chunk_len=512, prepared=prep)
    assert a == b == native.count(data, 0)[::-1]


def test_scanner_escalates_to_big_phi():
    """A never-converging S>128 machine on a hostile corpus must end
    up on the big-φ tier via the warmup-escalation ladder."""
    pat = rb"b(?:a{137})*b"
    ast, _ = parse(pat)
    prog = compile_regex(ast)
    sc = Scanner(prog, use_device=True, ast=ast)
    sc.DEVICE_THRESHOLD = 1 << 12
    rng = random.Random(5)
    # long a-runs defeat every warmup window (history = run length)
    data = bytearray(b"a" * 300_000)
    for _ in range(60):
        data[rng.randrange(len(data))] = ord(b"b")
    data = bytes(data)
    exp = sc._native.count(data, 0)[0] + int(
        sc.dfa.match_eof[sc._native.count(data, 0)[1]])
    for _ in range(9):          # strikes accumulate across scans
        # (ladder 32 -> 128 -> 512 -> 2048 -> phi: 2 strikes per rung)
        got = sc.count(data)
        assert got == exp
    tiers = {sc.stats().tier}
    got = sc.count(data)
    assert got == exp
    tiers.add(sc.stats().tier)
    assert "PhiTablesBig" in tiers, tiers
