"""Pipelined streaming scan (ops/pipeline.py) vs the single-buffer
drivers and the native engine (the plain walk on the CPU mesh).

The pipeline's exactness argument — a non-first segment's chunk 0
speculates over the real previous-segment tail and is validated
against the true entry at fold time — is exercised with adversarial
segmentations: 1-byte segments, segments smaller than the warmup
window, ragged non-final segments (forced native bad_tail repair),
and patterns whose warmup cannot converge (long counted runs), which
drive the cross-segment repair path."""

import random

import pytest

from sregex_tpu import parse, compile_regex
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops.pallas_scan import SpecTables, SpecTablesWide
from sregex_tpu.ops.pallas_pair import SpecTablesPair
from sregex_tpu.ops.pipeline import pipelined_count, pipelined_scan


def _segments(data, rng):
    """Adversarial random segmentation: tiny, sub-warmup, ragged and
    chunk-multiple segment lengths all mixed."""
    segs = []
    i = 0
    while i < len(data):
        k = rng.choice([1, 3, 17, 100, 240, 480, 1000, 4096])
        segs.append(data[i:i + k])
        i += k
    return segs


def _corpus(rng, alphabet, n, plants):
    data = bytes(rng.choice(alphabet) for _ in range(n))
    for pos, s in plants:
        data = data[:pos] + s + data[pos:]
    return data


CASES = [
    # (pattern, tables class, alphabet, plant string)
    ("ab", SpecTables, b"aabbc ", b"ab"),
    ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", SpecTablesPair, b"abc",
     b"baaaacca"),
    (r"\bword\b", SpecTables, b"word x", b" word "),
    ("a{60}b", SpecTablesWide, b"aaaaaab", b"c" + b"a" * 60 + b"b"),
]


@pytest.mark.parametrize("pattern,cls,alphabet,plant", CASES)
def test_pipelined_count_matches_native(pattern, cls, alphabet,
                                        plant):
    ast, _ = parse(pattern)
    dfa = build_dfa(compile_regex(ast))
    tables = cls(dfa)
    native = NativeDfa(dfa)
    rng = random.Random(hash(pattern) & 0xFFFF)
    for trial in range(3):
        n = rng.choice([900, 5000, 9000])
        data = _corpus(rng, alphabet, n,
                       [(n // 3, plant), (2 * n // 3, plant)])
        segs = _segments(data, rng)
        exp, est = native.count(data, 0)
        st, got = pipelined_count(tables, segs, chunk_len=240,
                                  in_flight=rng.choice([1, 2, 3]))
        assert got == exp, (pattern, trial, got, exp)
        assert st == est, (pattern, trial, st, est)


@pytest.mark.parametrize("pattern,cls,alphabet,plant", CASES)
def test_pipelined_scan_matches_native(pattern, cls, alphabet, plant):
    ast, _ = parse(pattern)
    dfa = build_dfa(compile_regex(ast))
    tables = cls(dfa)
    native = NativeDfa(dfa)
    rng = random.Random(~hash(pattern) & 0xFFFF)
    for trial in range(3):
        n = rng.choice([900, 5000])
        plants = [] if trial == 0 else [(n // 2, plant)]
        data = _corpus(rng, alphabet, n, plants)
        segs = _segments(data, rng)
        exp_first, est = native.scan_first(data, 0)
        st, got, byte, folded = pipelined_scan(tables, segs,
                                               chunk_len=240)
        assert got == exp_first, (pattern, trial, got, exp_first)
        if exp_first < 0:
            assert st == est and folded == len(data)
        else:
            assert byte == data[exp_first]


def test_pipelined_single_and_empty_segments():
    ast, _ = parse("ab")
    tables = SpecTables(build_dfa(compile_regex(ast)))
    native = NativeDfa(build_dfa(compile_regex(ast)))
    data = b"xxabxx" * 100
    exp, est = native.count(data, 0)
    st, got = pipelined_count(tables, [b"", data, b""], chunk_len=240)
    assert (got, st) == (exp, est)
    st, got = pipelined_count(tables, [], chunk_len=240)
    assert (st, got) == (0, 0)
    st, got, byte, folded = pipelined_scan(tables, iter([]))
    assert (st, got) == (0, -1)


def test_pipelined_pair_odd_segments():
    """Pair-unit tables must stay pair-aligned across odd-length
    segments (the odd-byte holdback)."""
    ast, _ = parse("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
    dfa = build_dfa(compile_regex(ast))
    tables = SpecTablesPair(dfa)
    assert tables.bpu == 2
    native = NativeDfa(dfa)
    rng = random.Random(99)
    data = _corpus(rng, b"abc", 4001, [(1234, b"baaaacca"),
                                       (3999, b"abbbcca")])
    # every segment odd-length
    segs = [data[i:i + 333] for i in range(0, len(data), 333)]
    assert all(len(s) % 2 for s in segs[:-1])
    exp, est = native.count(data, 0)
    st, got = pipelined_count(tables, segs, chunk_len=240)
    assert (got, st) == (exp, est)


def test_pipelined_entry_state():
    """A nonzero entry state threads into the first segment's frozen
    warmup exactly like the single-buffer driver."""
    ast, _ = parse("ab")
    dfa = build_dfa(compile_regex(ast))
    tables = SpecTables(dfa)
    native = NativeDfa(dfa)
    # state after consuming "a"
    _, mid = native.count(b"xa", 0)
    data = b"b" + b"xab" * 400
    exp, est = native.count(data, mid)
    st, got = pipelined_count(tables, [data[:7], data[7:]],
                              chunk_len=240, entry_state=mid)
    assert (got, st) == (exp, est)


def test_scanner_stream_api():
    """Scanner.count_stream / scan_stream == count / scan on the
    concatenation, on both the device pipeline and the host
    fallback."""
    from sregex_tpu.stream import Scanner
    ast, _ = parse("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
    prog = compile_regex(ast)
    rng = random.Random(5)
    data = _corpus(rng, b"abc", 6000, [(3000, b"baaaacca")])
    segs = _segments(data, rng)
    for use_device in (True, False):
        sc = Scanner(prog, use_device=use_device, ast=ast)
        sc.DEVICE_THRESHOLD = 0     # small stream: force device path
        assert sc.count_stream(list(segs)) == sc.count(data)
        assert sc.scan_stream(list(segs)) == sc.scan(data)
    # no-match stream: EOF/None handling
    sc = Scanner(prog, use_device=True, ast=ast)
    sc.DEVICE_THRESHOLD = 0
    quiet = [b"xyz" * 100] * 3
    assert sc.scan_stream(quiet) == sc.scan(b"xyz" * 300)
    assert sc.count_stream([b"xyz" * 100] * 3) == 0
    assert not sc.match_stream([b"xyz" * 100] * 3)
    assert sc.match_stream(_segments(data, rng))


def test_pipelined_count_on_mesh():
    """The pipeline's kernels ride the device mesh like the
    single-buffer drivers (shard_map over the chunk-block dim; the
    fold is mesh-agnostic)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    ast, _ = parse("ab")
    dfa = build_dfa(compile_regex(ast))
    tables = SpecTables(dfa)
    native = NativeDfa(dfa)
    rng = random.Random(21)
    data = _corpus(rng, b"aabbc ", 7000, [(3500, b"abab")])
    segs = [data[i:i + 1700] for i in range(0, len(data), 1700)]
    exp, est = native.count(data, 0)
    st, got = pipelined_count(tables, segs, chunk_len=240, mesh=mesh)
    assert (got, st) == (exp, est)


def test_pipelined_core_tier_matches_native():
    """The adaptive core tier rides the pipeline: segment folds walk
    the trusted-run chain in FULL-machine states, and escapes (data
    the sampled core never saw) repair natively per chunk — exactness
    never depends on the sample."""
    from sregex_tpu.ops.pallas_core import CoreTables
    ast, _ = parse("a{10,30}b")
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    native = NativeDfa(dfa)
    rng = random.Random(13)
    # sample from escape-free data; the corpus then contains deep
    # counted-chain runs (escapes) and real matches
    ct = CoreTables(dfa, bytes(rng.choice(b"abx ") for _ in range(2000)))
    data = _corpus(rng, b"abx ", 6000,
                   [(1500, b"c" + b"a" * 20 + b"b"),
                    (3000, b"a" * 40),          # escape, no match
                    (4500, b"a" * 12 + b"b")])
    segs = _segments(data, rng)
    exp, est = native.count(data, 0)
    st, got = pipelined_count(ct, segs, chunk_len=240)
    assert (got, st) == (exp, est)
    assert ct.last_repair is not None    # drift stats recorded
    exp_first, est2 = native.scan_first(data, 0)
    st2, got2, byte, folded = pipelined_scan(ct, _segments(data, rng),
                                             chunk_len=240)
    assert got2 == exp_first
    if exp_first >= 0:
        assert byte == data[exp_first]
    else:
        assert st2 == est2 and folded == len(data)


def test_pipelined_core_nonhot_entry():
    """A first-segment entry state outside the core cannot be frozen:
    chunk 0 speculates and the fold repairs it on the full machine."""
    from sregex_tpu.ops.pallas_core import CoreTables
    ast, _ = parse("a{10,30}b")
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    native = NativeDfa(dfa)
    ct = CoreTables(dfa, b"xbxa ab" * 300)
    # drive the full machine 15 a's deep: almost surely not hot
    _, deep = native.count(b"a" * 15, 0)
    if ct.to_core_premult(deep) >= 0:
        pytest.skip("entry unexpectedly hot")
    data = b"a" * 10 + b"b" + b"x ab" * 500
    exp, est = native.count(data, deep)
    st, got = pipelined_count(ct, [data[:7], data[7:]],
                              chunk_len=240, entry_state=deep)
    assert (got, st) == (exp, est)


def test_scanner_stream_lazy_core():
    """A pattern past the eager DFA budget streams on the lazy-backed
    core tier sampled from the FIRST segment (Scanner._stream_tables),
    byte-exact against the lazy oracle."""
    from sregex_tpu.stream import compile_pattern
    from sregex_tpu.dfa import LazyDfa
    from sregex_tpu.ops.pallas_core import LazyCoreTables
    sc = compile_pattern(b"foo[a-z]{20,40}z", use_device=True)
    assert sc.dfa is None            # past the eager budget
    sc.CORE_SAMPLE = 1 << 10         # sample fits the test segments
    sc.DEVICE_THRESHOLD = 0          # small stream: force device path
    rng = random.Random(47)
    data = bytes(rng.choice(b"fghij x") for _ in range(20000))
    planted = b"foo" + b"ghijabcdeghijabcdeghijabcde"[:25] + b"z"
    data = data[:5000] + planted + data[5000:15000] + planted \
        + data[15000:]
    segs = [data[i:i + 3001] for i in range(0, len(data), 3001)]
    oracle = LazyDfa(sc.program)
    exp_cnt, exp_st = oracle.count(data, 0)
    assert exp_cnt >= 2
    got = sc.count_stream(list(segs))
    assert got == exp_cnt + int(oracle.match_eof(exp_st))
    assert isinstance(sc._lazy_coret, LazyCoreTables)
    exp_first, exp_state = oracle.scan_first(data, 0)
    rid, end = sc.scan_stream(list(segs))
    assert end == exp_first
    assert rid == oracle.id_at(exp_state, data[exp_first])


def test_scanner_stream_dense_core():
    """A dense-DFA pattern whose static chain bottoms out streams on
    the adaptive core tier built from the first segment."""
    from sregex_tpu.stream import compile_pattern
    from sregex_tpu.ops.pallas_core import CoreTables
    sc = compile_pattern("word (?:[a-zA-Z0-9]+ ){0,10}otherword",
                         use_device=True)
    if sc.dfa is None or sc._core_eligible(sc._spec) is None:
        pytest.skip("pattern no longer lands past the fast tiers")
    sc.CORE_SAMPLE = 1 << 10
    sc.DEVICE_THRESHOLD = 0
    rng = random.Random(31)
    data = bytes(rng.choice(b"word other ab1 ") for _ in range(12000))
    data = data[:6000] + b" word ab c1 otherword " + data[6000:]
    segs = [data[i:i + 2501] for i in range(0, len(data), 2501)]
    assert sc.count_stream(list(segs)) == sc.count(data)
    assert isinstance(sc._coret, CoreTables)
    assert sc.scan_stream(list(segs)) == sc.scan(data)


def test_scanner_stream_eof_boundary():
    """A match that ends exactly at EOF is reported at the total
    stream length (the count includes it; scan returns (id, n))."""
    from sregex_tpu.stream import Scanner
    ast, _ = parse(r"tail\z")
    prog = compile_regex(ast)
    data = b"x" * 500 + b"tail"
    segs = [data[:100], data[100:503], data[503:]]
    for use_device in (True, False):
        sc = Scanner(prog, use_device=use_device, ast=ast)
        sc.DEVICE_THRESHOLD = 0
        assert sc.count_stream(list(segs)) == 1
        assert sc.scan_stream(list(segs)) == (0, len(data))


def test_pipeline_snapshots_reused_buffers():
    """A producer that reuses its read buffer between yields (the
    readinto file/network pattern) must not corrupt segments the fold
    hasn't consumed yet: dispatch snapshots mutable segments."""
    ast, _ = parse("ab")
    dfa = build_dfa(compile_regex(ast))
    tables = SpecTables(dfa)
    native = NativeDfa(dfa)
    rng = random.Random(99)
    data = _corpus(rng, b"aabbc ", 20000, [(9000, b"abab")])
    exp, est = native.count(data, 0)

    def reusing_producer():
        buf = bytearray(1700)
        for i in range(0, len(data), 1700):
            chunk = data[i:i + 1700]
            buf[:len(chunk)] = chunk
            yield memoryview(buf)[:len(chunk)]

    st, got = pipelined_count(tables, reusing_producer(),
                              chunk_len=240, in_flight=3)
    assert (got, st) == (exp, est)


def test_scanner_stream_small_gates_to_host():
    """Streams below DEVICE_THRESHOLD take the native carry loop (no
    per-segment dispatch RTT), with identical results."""
    from sregex_tpu.stream import Scanner
    ast, _ = parse("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
    prog = compile_regex(ast)
    rng = random.Random(7)
    data = _corpus(rng, b"abc", 5000, [(2500, b"baaaacca")])
    segs = _segments(data, rng)
    sc = Scanner(prog, use_device=True, ast=ast)
    assert sc.DEVICE_THRESHOLD > len(data)   # default gating applies
    tables, it, note = sc._stream_tables(list(segs))
    assert tables is None and note is None
    assert b"".join(bytes(s) for s in it) == data  # stream intact
    assert sc.count_stream(list(segs)) == sc.count(data)
    assert sc.scan_stream(list(segs)) == sc.scan(data)
