"""Streaming API tests: StreamScanner resume semantics vs whole-buffer
results; Scanner.find/finditer/count vs Python re."""

import re as pyre

import pytest

from sregex_tpu.consts import SRE_OK, SRE_AGAIN, SRE_DECLINED, SRE_ERROR
from sregex_tpu.stream import StreamScanner, Scanner, compile_pattern
from sregex_tpu import parse, compile_regex
from sregex_tpu.dfa import build_dfa


CASES = [
    ("abc", b"xxabcxx"),
    ("a+b", b"caaab"),
    ("nomatch", b"hay hay hay"),
    (r"\bw\d+", b"say w42 now"),
    ("^line", b"text\nline"),
    ("end$", b"the end\nmore"),
]


@pytest.mark.parametrize("pattern,data", CASES)
def test_stream_chunking_invariance(pattern, data):
    ast, _ = parse(pattern)
    prog = compile_regex(ast)
    dfa = build_dfa(prog)

    whole = StreamScanner(dfa)
    rc_w, end_w = whole.exec(data, eof=True)

    for size in (1, 2, 3, len(data)):
        s = StreamScanner(dfa)
        rc = SRE_AGAIN
        end = -1
        for i in range(0, len(data), size):
            rc, end = s.exec(data[i:i + size], eof=False)
            if rc != SRE_AGAIN:
                break
        if rc == SRE_AGAIN:
            rc, end = s.exec(b"", eof=True)
        assert (rc, end) == (rc_w, end_w), \
            "%r size=%d: %r != %r" % (pattern, size, (rc, end),
                                      (rc_w, end_w))


def test_stream_error_after_eof():
    ast, _ = parse("x")
    dfa = build_dfa(compile_regex(ast))
    s = StreamScanner(dfa)
    assert s.exec(b"abc", eof=True)[0] == SRE_DECLINED
    assert s.exec(b"x", eof=True)[0] == SRE_ERROR


@pytest.mark.parametrize("pattern,data", [
    ("a+", b"aa b aaa c a"),
    ("x", b"no here"),
    (r"\d+", b"n 12 and 345"),
])
def test_scanner_find_finditer(pattern, data):
    sc = compile_pattern(pattern)
    m = pyre.search(pattern.encode(), data)
    got = sc.find(data)
    if m is None:
        assert got is None
        assert not sc.match(data)
    else:
        assert got is not None
        rid, ov = got
        assert (ov[0], ov[1]) == (m.start(), m.end())
        assert sc.match(data)

    spans = [(ov[0], ov[1]) for _, ov in sc.finditer(data)]
    expected = [(m.start(), m.end())
                for m in pyre.finditer(pattern.encode(), data)]
    assert spans == expected


def test_scanner_count():
    sc = compile_pattern("ab")
    # boundaries where a match ends: one per "ab" occurrence
    assert sc.count(b"ab ab zab") == 3
    assert sc.count(b"") == 0


def test_multi_pattern_scanner():
    sc = compile_pattern([b"foo", b"bar"])
    rid, ov = sc.find(b"xx bar foo")
    assert rid == 1 and (ov[0], ov[1]) == (3, 6)


def test_scanner_device_paths():
    # exercise the device-backed match/count through the public API
    # (the plain walk on the CPU); force a tiny
    # threshold so small corpora take the device path
    sc = Scanner(compile_pattern("ab").program, use_device=True)
    if sc._spec is None:
        pytest.skip("pattern too large for the spec kernel")
    sc.DEVICE_THRESHOLD = 0
    data = b"xab" * 700
    assert sc.match(data)
    assert sc.count(data) == 700
    assert not Scanner(compile_pattern("zq").program,
                       use_device=True).match(data)


def test_multi_pattern_device_scan():
    # multi-regex programs compile into one DFA: device count counts
    # boundaries where ANY pattern matches
    sc = Scanner(compile_pattern([b"foo", b"bar"]).program,
                 use_device=True)
    if sc._spec is None:
        pytest.skip("combined automaton too large")
    sc.DEVICE_THRESHOLD = 0
    data = b"foo bar foo zz" * 100
    assert sc.count(data) == 300


@pytest.mark.parametrize("pattern,data", [
    ("a|ba", b"zzba zz"),
    ("ab|b", b"xxabxx"),
    (r"\bcat\b", b"scatter cat s"),
    ("^line", b"text\nline two"),
    (r"end$", b"the end\nmore end"),
    (r"(\w+)@(\w+)", b"big haystack " * 50 + b"user@host tail"),
    (r"\Astart", b"start here"),
    (r"tail\z", b"x tail"),
    ("(a+)(b+)?", b"zzzaab"),
    ("nomatch", b"hay hay"),
])
def test_find_fast_equals_full_pike(pattern, data):
    # the reverse-scan fast path must give exactly the full-engine span
    sc = compile_pattern(pattern)
    fast = sc.find(data)
    ctx = sc._pike_ctx()
    rc, _ = ctx.exec(data, True)
    full = None if rc < 0 else (rc, [int(v) for v in ctx.ovector])
    assert fast == full, "%r: fast %r != full %r" % (pattern, fast, full)
    # and the reverse path really engaged for matching cases
    if full is not None:
        assert sc._rev_dfa() is not None


def test_find_device_reverse_path():
    # both forward and reverse scans on the device path
    sc = Scanner(compile_pattern(rb"u@h").program, use_device=True,
                 ast=None)
    # ast=None disables the fast path; build a proper one instead
    from sregex_tpu import parse, compile_regex
    ast, _ = parse(rb"(\w)@(\w)")
    sc = Scanner(compile_regex(ast), use_device=True, ast=ast)
    sc.DEVICE_THRESHOLD = 0
    sc._tdfa_spec = None   # force the reverse-scan path (the one-pass
    # tagged-DFA kernel would otherwise answer first; it has its own
    # tests in test_tdfa_device.py)
    sc._tdfa_coret = False  # ... and so would the hot-core tagged
    # tier that backs find() past the dense budget (test_tdfa_core.py)
    data = b"hay " * 800 + b"u@h" + b" more" * 10
    got = sc.find(data)
    assert got is not None
    rid, ov = got
    assert (ov[0], ov[1]) == (3200, 3203)
    assert sc._rev_spec is not None  # device reverse tables engaged


def test_stream_scanner_device_backend():
    ast, _ = parse("needle")
    dfa = build_dfa(compile_regex(ast))
    s = StreamScanner(dfa, use_device=True)
    s.DEVICE_THRESHOLD = 0
    data = b"hay " * 500 + b"needle" + b" hay" * 100
    rc, end = s.exec(data, eof=True)
    assert rc == SRE_OK and end == 2006


def test_prepared_corpus_reuse():
    """Scanner.prepare(data) packs once; match/count/scan reuse the
    device-resident corpus across calls and tiers, byte-identical to
    the unprepared path."""
    import random
    from sregex_tpu.stream import compile_pattern
    rng = random.Random(7)
    # spec-tier pattern
    sc = compile_pattern(b"(?:a|b)aa(?:aa|bb)cc(?:a|b)",
                         use_device=True)
    sc.DEVICE_THRESHOLD = 1 << 12
    data = bytes(rng.choice(b"abccc x") for _ in range(30000))
    data = data[:20000] + b"xaaabbccb" + data[20000:]
    h = sc.prepare(data)
    assert sc.count(data, prepared=h) == sc.count(data)
    assert sc.scan(data, prepared=h) == sc.scan(data)
    assert sc.match(data, prepared=h) == sc.match(data)
    assert sc.find(data, prepared=h) == sc.find(data)

    # adaptive-core-tier pattern
    sc2 = compile_pattern(b"a{60,120}b")
    sc2.use_device = True
    sc2.DEVICE_THRESHOLD = 1 << 12
    d2 = bytes(rng.choice(b"ab xx") for _ in range(30000))
    d2 = d2[:9000] + b"c" + b"a" * 90 + b"b" + d2[9000:]
    h2 = sc2.prepare(d2)
    assert sc2.count(d2, prepared=h2) == sc2.count(d2)
    assert sc2.scan(d2, prepared=h2) == sc2.scan(d2)

    # lazy-core pattern (past the eager DFA budget)
    sc3 = compile_pattern(b"foo[a-z]{20,40}z", use_device=True)
    assert sc3.dfa is None
    sc3.DEVICE_THRESHOLD = 1 << 12
    d3 = bytes(rng.choice(b"fghij x") for _ in range(30000))
    d3 = d3[:9000] + b"foo" + b"ghij" * 6 + b"z" + d3[9000:]
    h3 = sc3.prepare(d3)
    assert sc3.count(d3, prepared=h3) == sc3.count(d3)
    assert sc3.scan(d3, prepared=h3) == sc3.scan(d3)
    assert sc3.match(d3, prepared=h3)
