"""Adaptive hot-core tier (ops/pallas_core.py) vs the full native
machine, on the CPU mesh (the plain walk).

The exactness claim under test: core results NEVER depend on the
sample being representative — adversarial data that constantly
escapes the core must still produce byte-identical answers (only
slower, via the full-machine repair path)."""

import random

import numpy as np
import pytest

from sregex_tpu import parse, compile_regex
from sregex_tpu.dfa import build_dfa, build_core_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops.pallas_core import (CoreTables, core_scan_bytes,
                                        core_count_bytes,
                                        core_scan_last_bytes,
                                        core_chunk_map)


def _full(pattern, max_states=65536):
    ast, _ = parse(pattern)
    dfa = build_dfa(compile_regex(ast), max_states=max_states)
    return dfa, NativeDfa(dfa)


def test_build_core_dfa_identity_when_all_hot():
    dfa, native = _full(b"a{10,30}b")
    core, hot2full, full2core = build_core_dfa(
        dfa, np.arange(dfa.nstates))
    assert core.nstates == dfa.nstates + 1
    # lockstep simulation over random bytes: identical behavior, and
    # the core never escapes
    rng = random.Random(1)
    data = bytes(rng.choice(b"ab x") for _ in range(4000))
    s = t = 0
    for b in data:
        cf = dfa.class_map[b]
        cc = core.class_map[b]
        assert bool(dfa.match[s, cf]) == bool(core.match[t, cc])
        s = dfa.trans[s, cf]
        t = core.trans[t, cc]
        assert t < core.nstates - 1  # never ESC
        assert hot2full[t] == s


def test_build_core_dfa_escape_is_sticky_and_fires():
    dfa, native = _full(b"a{10,30}b")
    # hot set = states visited by pure "x" data (start-ish states)
    counts, _ = native.visits(b"x" * 100 + b"a" * 3, 0)
    hot = np.nonzero(counts)[0]
    hot = np.concatenate([[0], hot[hot != 0]])
    core, hot2full, full2core = build_core_dfa(dfa, hot)
    esc = core.nstates - 1
    # drive deep into the counted chain: must hit ESC and stay there
    t = 0
    escaped = False
    for b in b"a" * 50:
        c = core.class_map[b]
        if t == esc:
            escaped = True
            assert core.match[t, c]      # ESC transitions fire
        t = core.trans[t, c]
    assert escaped and t == esc          # sticky


PATTERNS = [
    # (pattern, benign alphabet, adversarial alphabet, planted match)
    (b"a{60,120}b", b"ab xx", b"a", b"c" + b"a" * 80 + b"b"),
    (b"word (?:[a-zA-Z0-9]+ ){0,10}otherword",
     b"word other abc12 ", b"abc12 ", b"word abc de3 otherword"),
    (b"(x|y|z[QW]){1,5}(longish|loquatious)",
     b"xyzQW longish loquatious", b"xyzQW",
     b"zQxylongish"),
]


@pytest.mark.parametrize("pattern,benign,adv,planted",
                         [(str(p), str(b), str(a), str(m))
                          for p, b, a, m in PATTERNS])
def test_core_scan_and_count_match_native(pattern, benign, adv,
                                          planted):
    pattern, benign, adv, planted = (eval(pattern), eval(benign),
                                     eval(adv), eval(planted))
    dfa, native = _full(pattern)
    rng = random.Random(len(pattern))
    sample = bytes(rng.choice(benign) for _ in range(20000))
    ct = CoreTables(dfa, sample)
    assert ct.core.nstates < dfa.nstates + 1

    datasets = []
    # benign (sample-like), with and without planted matches
    d = bytes(rng.choice(benign) for _ in range(3000))
    datasets.append(d)
    datasets.append(d[:1500] + planted + d[1500:])
    # adversarial: distribution the sample never saw -> escapes
    datasets.append(bytes(rng.choice(adv) for _ in range(2000)))
    # escape-dense alternation and ragged tails
    datasets.append((bytes(rng.choice(adv) for _ in range(97))
                     + bytes(rng.choice(benign) for _ in range(61)))
                    * 12 + b"tail")
    datasets.append(planted)
    datasets.append(b"")

    for data in datasets:
        exp_first, exp_state = native.scan_first(data, 0)
        got_state, got_first = core_scan_bytes(ct, data,
                                               chunk_len=256)
        assert got_first == exp_first, (pattern, len(data))
        assert got_state == exp_state, (pattern, len(data))
        exp_cnt, exp_st2 = native.count(data, 0)
        st2, got_cnt = core_count_bytes(ct, data, chunk_len=256)
        assert got_cnt == exp_cnt, (pattern, len(data))
        assert st2 == exp_st2, (pattern, len(data))


def test_core_escape_at_chunk_edges_fuzz():
    """Randomized chunk-edge stress: small chunks, data engineered so
    escapes land at arbitrary positions including chunk-final bytes
    (the case where an escaped chunk's fm can be clean and only the
    sticky-ESC exit betrays it)."""
    pattern = b"a{60,120}b"
    dfa, native = _full(pattern)
    rng = random.Random(99)
    ct = CoreTables(dfa, bytes(rng.choice(b"ab xx")
                               for _ in range(20000)))
    for trial in range(12):
        parts = []
        for _ in range(rng.randrange(2, 30)):
            parts.append(b"x" * rng.randrange(0, 70))
            parts.append(b"a" * rng.randrange(0, 130))
            if rng.random() < 0.3:
                parts.append(b"b")
        data = b"".join(parts)
        exp_first, exp_state = native.scan_first(data, 0)
        got_state, got_first = core_scan_bytes(ct, data, chunk_len=64)
        assert (got_first, got_state) == (exp_first, exp_state), trial
        exp_cnt, exp_st = native.count(data, 0)
        st, got_cnt = core_count_bytes(ct, data, chunk_len=64)
        assert (got_cnt, st) == (exp_cnt, exp_st), trial


def test_core_covers_saturating_counted_rep():
    """[ab]{120,250}c on all-[ab] data ramps through ~250 states then
    SATURATES into a small recurring set — the core must cover it
    (ramp states carry real sampled mass, so nothing may be pruned
    at the default escape budget) and still answer exactly."""
    dfa, native = _full(b"[ab]{120,250}c")
    rng = random.Random(5)
    sample = bytes(rng.choice(b"ab") for _ in range(50000))
    ct = CoreTables(dfa, sample)
    data = (bytes(rng.choice(b"ab") for _ in range(1500)) + b"c"
            + bytes(rng.choice(b"abc ") for _ in range(800)))
    exp_first, exp_state = native.scan_first(data, 0)
    got_state, got_first = core_scan_bytes(ct, data, chunk_len=256)
    assert (got_first, got_state) == (exp_first, exp_state)
    exp_cnt, exp_st = native.count(data, 0)
    st, got_cnt = core_count_bytes(ct, data, chunk_len=256)
    assert (got_cnt, st) == (exp_cnt, exp_st)


def test_core_wide_alphabet_hot_set():
    """18 multi-regex literals with distinct leading bytes: the hot
    rows distinguish >16 byte classes, past the 4-bit-packed fast
    tiers — but the 8-bit-packed WIDE tier now takes them, both as a
    static tier and as a core inner.  Exactness on planted matches as
    usual; require_fast=True must still refuse (no narrow/pair fit
    exists)."""
    from sregex_tpu.parser import parse_multi
    pats = [bytes([c]) + b"zz" for c in range(ord("a"), ord("a") + 18)]
    ast, _ = parse_multi(pats, [0] * len(pats))
    dfa = build_dfa(compile_regex(ast))
    native = NativeDfa(dfa)
    rng = random.Random(11)
    sample = bytes(rng.choice(b"abcdefghijklmnopqrz ")
                   for _ in range(20000))
    ct = CoreTables(dfa, sample)
    assert ct.inner.bits == 8       # 8-bit-packed wide inner
    data = sample[:9000] + b"fzz" + sample[9000:15000] + b"qzz" \
        + sample[15000:]
    exp_c, exp_st = native.count(data, 0)
    st, got_c = core_count_bytes(ct, data, chunk_len=256)
    assert (got_c, st) == (exp_c, exp_st)
    exp_f, exp_s = native.scan_first(data, 0)
    st, f = core_scan_bytes(ct, data, chunk_len=256)
    assert (f, st) == (exp_f, exp_s)
    # a narrow/pair-only fit still does not exist
    with pytest.raises(ValueError):
        CoreTables(dfa, sample, require_fast=True)


@pytest.mark.parametrize("pattern,benign,adv,planted",
                         [(str(p), str(b), str(a), str(m))
                          for p, b, a, m in PATTERNS])
def test_core_scan_last_and_chunk_map_match_native(pattern, benign,
                                                   adv, planted):
    pattern, benign, adv, planted = (eval(pattern), eval(benign),
                                     eval(adv), eval(planted))
    dfa, native = _full(pattern)
    rng = random.Random(len(pattern) * 7)
    sample = bytes(rng.choice(benign) for _ in range(20000))
    ct = CoreTables(dfa, sample)

    K = 256
    d = bytes(rng.choice(benign) for _ in range(3000))
    datasets = [
        d,
        d[:700] + planted + d[700:1900] + planted + d[1900:],
        bytes(rng.choice(adv) for _ in range(2000)),
        (bytes(rng.choice(adv) for _ in range(97))
         + bytes(rng.choice(benign) for _ in range(61))) * 12 + b"t",
        planted,
        b"",
    ]
    for data in datasets:
        exp_last, exp_state = native.scan_last(data, 0)
        got_state, got_last = core_scan_last_bytes(ct, data,
                                                   chunk_len=K)
        assert (got_last, got_state) == (exp_last, exp_state), \
            (pattern, len(data))
        # chunk-map oracle: native per-chunk walk
        entries, counts, final = core_chunk_map(ct, data, chunk_len=K)
        s = 0
        for c in range(len(counts)):
            assert int(entries[c]) == s, (pattern, len(data), c)
            k, s = native.count(data[c * K:(c + 1) * K], s)
            assert int(counts[c]) == k, (pattern, len(data), c)
        assert final == s, (pattern, len(data))


def test_scanner_routes_big_patterns_through_core():
    from sregex_tpu.stream import compile_pattern
    from sregex_tpu.ops.pallas_big import SpecTablesBig
    sc = compile_pattern(b"a{60,120}b")
    sc.use_device = True
    sc._spec = None if sc.dfa is None else sc._spec
    # force the device path at test sizes
    sc.DEVICE_THRESHOLD = 1 << 12
    rng = random.Random(3)
    data = bytes(rng.choice(b"ab xx") for _ in range(40000))
    data = data[:9000] + b"c" + b"a" * 90 + b"b" + data[9000:]
    dfa, native = sc.dfa, sc._native
    if not isinstance(sc._spec, SpecTablesBig) and sc._spec is not None:
        pytest.skip("pattern unexpectedly fits a fast static tier")
    exp_cnt, exp_st = native.count(data, 0)
    exp_total = exp_cnt + int(dfa.match_eof[exp_st])
    assert sc.count(data) == exp_total
    assert sc._coret not in (None, False)  # core engaged
    exp_first, exp_state = native.scan_first(data, 0)
    rid, end = sc.scan(data)
    assert end == exp_first
    assert rid == dfa.id_at(exp_state, data[exp_first])


def test_core_engages_over_static_wide_tier(monkeypatch):
    """A pattern whose static tier is the slow row-select WIDE tier
    but whose scan hot set is tiny must upgrade to a fast (pair/
    narrow) core — and ONLY a fast one (require_fast: a wide core
    could never beat the static wide tier we already have).  The
    cached core must then stay exact on a later corpus containing
    matches (ramp states outside the core -> escape repair).

    (SREGEX_AFFINE=0 / SREGEX_FUSED=0: counted-rep chains land on
    the piecewise-affine tier and long-chain wides on the fused
    two-phase path by default — this test pins the LEGACY
    core-over-wide logic, still the fallback when those decline.)"""
    monkeypatch.setenv("SREGEX_AFFINE", "0")
    monkeypatch.setenv("SREGEX_FUSED", "0")
    from sregex_tpu.stream import compile_pattern
    from sregex_tpu.ops.pallas_scan import SpecTablesWide
    sc = compile_pattern(b"foo[a-z]{8,18}bar", use_device=True)
    assert isinstance(sc._spec, SpecTablesWide)
    assert sc._spec.rows > 4          # long chain: core-eligible
    sc.DEVICE_THRESHOLD = 1 << 12
    rng = random.Random(31)
    benign = bytes(rng.choice(b"ghij x") for _ in range(40000))
    native = sc._native
    exp_cnt, exp_st = native.count(benign, 0)
    assert sc.count(benign) == exp_cnt + int(sc.dfa.match_eof[exp_st])
    assert isinstance(sc._coret, CoreTables)
    assert not isinstance(sc._coret.inner, SpecTablesWide)
    # match-bearing corpus against the cached benign-built core
    data = (benign[:9000] + b"fooghijghijghbar" + benign[9000:30000]
            + b"foojjjjjjjjbar" + benign[30000:])
    exp_cnt, exp_st = native.count(data, 0)
    assert exp_cnt > 0
    assert sc.count(data) == exp_cnt + int(sc.dfa.match_eof[exp_st])
    exp_first, exp_state = native.scan_first(data, 0)
    rid, end = sc.scan(data)
    assert end == exp_first
    assert rid == sc.dfa.id_at(exp_state, data[exp_first])
    # a SHORT wide chain must stay on its static tier (the Scanner's
    # decision band)
    sc2 = compile_pattern(b"q[ab]{40,90}z", use_device=True)
    assert isinstance(sc2._spec, SpecTablesWide) and sc2._spec.rows <= 4
    sc2.DEVICE_THRESHOLD = 1 << 12
    assert sc2.count(benign) == 0
    assert sc2._coret is False


def test_lazy_core_serves_dfa_too_large_patterns():
    """Patterns past the eager DFA budget (no dense machine exists)
    must still get a device path: the lazy-backed adaptive core tier
    (LazyCoreTables) runs the fast kernels over the sampled hot set
    and repairs escapes on the lazy Python walk — byte-exact against
    the pure-lazy oracle, including the regex id."""
    from sregex_tpu.stream import compile_pattern
    from sregex_tpu.dfa import LazyDfa
    from sregex_tpu.ops.pallas_core import LazyCoreTables
    pat = b"foo[a-z]{20,40}z"
    sc = compile_pattern(pat, use_device=True)
    assert sc.dfa is None          # past the eager budget
    sc.DEVICE_THRESHOLD = 1 << 12
    rng = random.Random(47)
    # benign corpus: no 'o', so the ramp is never entered
    data = bytes(rng.choice(b"fghij x") for _ in range(40000))
    planted = b"foo" + b"ghijabcdeghijabcdeghijabcde"[:25] + b"z"
    data = data[:9000] + planted + data[9000:30000] + planted \
        + data[30000:]
    oracle = LazyDfa(sc.program)
    exp_cnt, exp_st = oracle.count(data, 0)
    assert exp_cnt >= 2
    got = sc.count(data)
    assert got == exp_cnt + int(oracle.match_eof(exp_st))
    assert isinstance(sc._lazy_coret, LazyCoreTables)
    exp_first, exp_state = oracle.scan_first(data, 0)
    rid, end = sc.scan(data)
    assert end == exp_first
    assert rid == oracle.id_at(exp_state, data[exp_first])
    assert sc.match(data)
    # adversarial: distribution the sample never saw (escape repair
    # on the lazy machine), still exact
    adv = bytes(rng.choice(b"fo") for _ in range(20000))
    exp_cnt2, exp_st2 = oracle.count(adv, 0)
    assert sc.count(adv) == exp_cnt2 + int(oracle.match_eof(exp_st2))
    # lazy scan_last (reverse-scan primitive, lazy flavor)
    from sregex_tpu.ops.pallas_core import core_scan_last_bytes
    ct = sc._lazy_coret
    st, last = core_scan_last_bytes(ct, data, chunk_len=256)
    exp_last, exp_lst = oracle.scan_last(data, 0)
    assert (last, st) == (exp_last, exp_lst)


def test_scanner_recore_on_corpus_drift():
    """A core built from one corpus degrades to repair-heavy scans on
    differently-distributed data; after two consecutive drifted scans
    the Scanner must rebuild the core from the CURRENT corpus (and
    every answer must stay exact throughout)."""
    from sregex_tpu.stream import compile_pattern
    sc = compile_pattern(b"a{60,120}b")
    sc.use_device = True
    sc.DEVICE_THRESHOLD = 1 << 12
    rng = random.Random(41)
    native = sc._native

    def check(data):
        exp_cnt, exp_st = native.count(data, 0)
        assert sc.count(data) == exp_cnt + int(sc.dfa.match_eof[exp_st])

    benign = bytes(rng.choice(b"xy z") for _ in range(40000))
    check(benign)
    core_a = sc._coret
    assert isinstance(core_a, CoreTables)
    # drifted corpus: short a-runs (well inside the warmup window, so
    # chunk-entry speculation still converges) escape core_a's tiny
    # hot set in most chunks
    drift = b"".join(b"a" * rng.randrange(3, 12) + b"x"
                     for _ in range(6000))
    check(drift)                  # strike 1 (exact via repair)
    assert sc._coret is core_a
    check(drift)                  # strike 2 -> schedule rebuild
    assert sc._coret is None and sc._coret_rebuilds == 1
    check(drift)                  # rebuilt from the drifted corpus
    core_b = sc._coret
    assert isinstance(core_b, CoreTables) and core_b is not core_a
    assert getattr(sc, "_coret_strikes", 0) == 0
    check(drift)                  # healthy on the new distribution


def test_stream_scanner_rides_core_tier():
    """StreamScanner.exec routes large chunks of big/wide-tier
    patterns through the adaptive core; the resumable carry and the
    SRE_OK offset must match the pure-native stream byte for byte,
    including a mid-stream entry state that may fall outside the
    core (per-chunk fallback)."""
    from sregex_tpu.stream import StreamScanner
    dfa, native = _full(b"a{60,120}b")
    rng = random.Random(17)
    dev = StreamScanner(dfa, use_device=True)
    ref = StreamScanner(dfa)
    dev.DEVICE_THRESHOLD = 1 << 12
    chunks = []
    for i in range(4):
        c = bytearray(rng.choice(b"ab xx") for _ in range(6000))
        if i == 2:
            # match straddles the chunk edge: ramp starts late in
            # chunk 2 (entry state of chunk 3 is deep, outside the
            # benign-sampled core)
            c[-50:] = b"x" + b"a" * 49
            chunks.append(bytes(c))
            c2 = bytearray(rng.choice(b"ab xx") for _ in range(6000))
            c2[:40] = b"a" * 39 + b"b"
            chunks.append(bytes(c2))
            continue
        chunks.append(bytes(c))
    for i, c in enumerate(chunks):
        eof = i == len(chunks) - 1
        got = dev.exec(c, eof)
        exp = ref.exec(c, eof)
        assert got == exp, (i, got, exp)
        assert dev.state == ref.state, i
        if got[0] == 0:            # SRE_OK: both finished
            break


def test_scanner_find_finditer_ride_rev_core():
    """find()'s reverse start scan and the finditer start locator
    must route big-tier REVERSE machines through the adaptive core
    tier and stay byte-exact with the host engines."""
    from sregex_tpu.stream import compile_pattern
    from sregex_tpu.ops.pallas_big import SpecTablesBig
    sc = compile_pattern(b"a{60,120}b")
    host = compile_pattern(b"a{60,120}b")
    sc.use_device = True
    sc.DEVICE_THRESHOLD = 1 << 12
    sc._tdfa_spec = None          # exercise the reverse-scan path
    rng = random.Random(21)
    data = bytes(rng.choice(b"ab xx") for _ in range(40000))
    data = (data[:9000] + b"c" + b"a" * 90 + b"b"
            + data[9000:30000] + b"c" + b"a" * 75 + b"b"
            + data[30000:])
    assert sc.find(data) == host.find(data)
    assert list(sc.finditer(data)) == list(host.finditer(data))
    # the reverse machine engaged the adaptive core tier (unless its
    # static chain already found a fast tier, in which case the core
    # correctly stays out of the way)
    if sc._rev_spec is None or isinstance(sc._rev_spec, SpecTablesBig):
        assert isinstance(sc._rev_coret, CoreTables)
    # no-match corpus: the locator must report no starts
    calm = bytes(rng.choice(b"ax") for _ in range(20000))
    calm = calm.replace(b"a" * 60, b"a" * 59 + b"x")
    assert sc.find(calm) == host.find(calm)
    assert list(sc.finditer(calm)) == list(host.finditer(calm))
