"""Piecewise-affine tier (ops/pallas_affine.py) vs the native oracle
(the plain walk on the CPU mesh)."""

import random

import numpy as np
import pytest

from sregex_tpu import parse, compile_regex
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops.pallas_affine import (SpecTablesAffine,
                                          detect_pieces)
from sregex_tpu.ops.pallas_scan import (spec_scan_bytes,
                                        spec_count_bytes,
                                        spec_scan_last_bytes)

CASES = [
    # (pattern, alphabet, plant)
    (rb"a{400,499}b", b"ab x", b"x" + b"a" * 450 + b"b"),
    (rb"[a-c]{450}x", b"abcx ", b"." + b"abc" * 150 + b"x"),
    (rb"a{499}b{499}c{499}", b"abc",
     b"a" * 499 + b"b" * 499 + b"c" * 499),
    (rb"\dA{300,400}z", b"7Az x", b"3" + b"A" * 350 + b"z"),
]


def _machine(pat):
    ast, _ = parse(pat)
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    return dfa


@pytest.mark.parametrize("pat,alpha,plant", CASES,
                         ids=[repr(p) for p, _, _ in CASES])
def test_affine_exact(pat, alpha, plant):
    dfa = _machine(pat)
    t = SpecTablesAffine(dfa)
    assert t.pieces <= 8
    native = NativeDfa(dfa)
    rng = random.Random(hash(pat) & 0xFFFF)
    for trial in range(3):
        n = rng.choice([60_000, 300_000, 2049])
        data = bytearray(rng.choice(alpha) for _ in range(n))
        if trial != 1:
            at = rng.randrange(0, max(1, n - len(plant) - 1))
            data[at:at + len(plant)] = plant
        data = bytes(data)
        exp_c, exp_st = native.count(data, 0)
        st, c = spec_count_bytes(t, data, chunk_len=512)
        assert (c, st) == (exp_c, exp_st), (pat, trial)
        exp_f, exp_st = native.scan_first(data, 0)
        st, f = spec_scan_bytes(t, data, chunk_len=512)
        assert (f, st) == (exp_f, exp_st), (pat, trial)
        exp_l, exp_st = native.scan_last(data, 0)
        st, l = spec_scan_last_bytes(t, data, chunk_len=512)
        assert (l, st) == (exp_l, exp_st), (pat, trial)


def test_detect_pieces_exactness_and_decline():
    dfa = _machine(rb"a{400,499}b")
    bounds, mode, val, match = detect_pieces(dfa)
    assert len(bounds) <= 4
    # a branching (non-chain) machine declines the tight piece cap
    dfa2 = _machine(rb"(x|y|z[QW]){1,5}(longish|loquatious)")
    with pytest.raises(ValueError):
        SpecTablesAffine(dfa2, max_pieces=6)


def test_scanner_routes_counted_rep_to_affine():
    from sregex_tpu.stream import Scanner
    pat = rb"a{60,120}b"
    ast, _ = parse(pat)
    prog = compile_regex(ast)
    sc = Scanner(prog, use_device=True, ast=ast)
    from sregex_tpu.ops.pallas_affine import SpecTablesAffine as A
    assert isinstance(sc._spec, A), type(sc._spec)
    sc.DEVICE_THRESHOLD = 1 << 12
    rng = random.Random(3)
    data = bytearray(rng.choice(b"aab x") for _ in range(200_000))
    data[1000:1082] = b"x" + b"a" * 80 + b"b"
    data = bytes(data)
    exp_c, exp_st = sc._native.count(data, 0)
    exp = exp_c + int(sc.dfa.match_eof[exp_st])
    assert sc.count(data) == exp
    assert sc.stats().tier == "SpecTablesAffine"


def test_affine_warmup_escalation_window():
    """with_warmup must work on the affine tier (bounded-history
    chains are exactly its machines)."""
    from sregex_tpu.ops.pallas_scan import with_warmup
    dfa = _machine(rb"a{400,499}b")
    t = SpecTablesAffine(dfa)
    t2 = with_warmup(t, 512)
    assert t2 is not None and t2.warmup == 512
    native = NativeDfa(dfa)
    rng = random.Random(9)
    # long a-runs: the default 32-byte window cannot converge, W=512
    # covers the bound
    data = bytearray()
    while len(data) < 150_000:
        data += b"a" * rng.randrange(300, 520) + b"b"
    data = bytes(data[:150_000])
    exp_c, exp_st = native.count(data, 0)
    st, c = spec_count_bytes(t2, data, chunk_len=1024)
    assert (c, st) == (exp_c, exp_st)
    nat, C = t2.last_repair
    assert nat <= max(2, C // 16), (nat, C)


def test_affine_periodic_renumbering_exact():
    """Branching counted repetitions ((?:ab?c){n,m}: W-periodic
    interleaved substates) are range-affine only after the
    residue-major renumbering (periodic_perm); the to_premult /
    from_premult hooks must keep entries, returned states, and native
    repairs in ORIGINAL dfa ids."""
    pat = rb"(?:ab?c){60,140}z"
    dfa = _machine(pat)
    t = SpecTablesAffine(dfa)
    assert t.perm is not None, "expected the renumbered path"
    native = NativeDfa(dfa)
    rng = random.Random(5)
    plant = b"." + b"abc" * 100 + b"z"
    for trial in range(3):
        n = rng.choice([80_000, 200_000, 3001])
        data = bytearray(rng.choice(b"abcz .") for _ in range(n))
        if trial != 2:
            at = rng.randrange(0, max(1, n - len(plant) - 1))
            data[at:at + len(plant)] = plant
        data = bytes(data)
        exp_c, exp_st = native.count(data, 0)
        st, c = spec_count_bytes(t, data, chunk_len=512)
        assert (c, st) == (exp_c, exp_st), trial
        exp_f, exp_st = native.scan_first(data, 0)
        st, f = spec_scan_bytes(t, data, chunk_len=512)
        assert (f, st) == (exp_f, exp_st), trial
        exp_l, exp_st = native.scan_last(data, 0)
        st, l = spec_scan_last_bytes(t, data, chunk_len=512)
        assert (l, st) == (exp_l, exp_st), trial


def test_affine_perm_chunk_map_and_batch():
    from sregex_tpu.ops.pallas_scan import spec_chunk_map
    from sregex_tpu.ops.batch import spec_count_many
    pat = rb"(?:ab?c){60,140}z"
    dfa = _machine(pat)
    t = SpecTablesAffine(dfa)
    assert t.perm is not None
    native = NativeDfa(dfa)
    rng = random.Random(11)
    data = bytes(rng.choice(b"abcz .") for _ in range(60_000))
    entries, counts, final = spec_chunk_map(t, data, chunk_len=512)
    # oracle walk
    e = 0
    for c in range(len(entries)):
        lo, hi = c * 512, min((c + 1) * 512, len(data))
        assert entries[c] == e, c
        k, e = native.count(data[lo:hi], e)
        assert counts[c] == k, c
    assert final == e
    docs = [bytes(rng.choice(b"abcz .") for _ in range(m))
            for m in (700, 2048, 5000)]
    counts, finals, nat, tot = spec_count_many(t, docs, chunk_len=512)
    for d, doc in enumerate(docs):
        k, st = native.count(doc, 0)
        assert (counts[d], finals[d]) == (k, st), d


def test_warm_ladder_2048_covers_product_histories():
    """Histories in (512, 2048) — chained counted reps — previously
    had NO converging window (the ladder capped at 512) and sat at
    the native-repair floor; W=2048 covers every parser-accepted
    counted-rep product (bounds < 500 per rep)."""
    from sregex_tpu.ops.pallas_scan import with_warmup
    dfa = _machine(rb"a{499}b{499}c{499}")
    t = SpecTablesAffine(dfa)
    t2 = with_warmup(t, 2048)
    assert t2 is not None and t2.warmup == 2048
    native = NativeDfa(dfa)
    rng = random.Random(17)
    # mid-chain entries: chunks can only converge with W >= ~1500
    data = bytearray()
    while len(data) < 120_000:
        data += (b"a" * 499 + b"b" * 499 + b"c" * rng.randrange(400, 520)
                 + b".")
    data = bytes(data[:120_000])
    exp = native.count(data, 0)
    st, c = spec_count_bytes(t2, data, chunk_len=2048)
    assert (c, st) == (exp[0], exp[1])
    nat, C = t2.last_repair
    assert nat <= max(2, C // 8), (nat, C)
