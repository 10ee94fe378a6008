"""Streaming events engine (events.py + Scanner.finditer_stream /
sub_stream): every segmentation of a stream must yield byte-identical
events/output to the whole-corpus finditer/sub oracle.

Covers the teleport soundness classes: bounded patterns (lookback
seeding), unbounded (sterile-boundary seeding, incl. the (?:ab)*c
minimization-merge adversary), empty-matching, anchored, multi-regex,
captures, and the monster fallback (no dense DFA)."""

import random

import pytest

from sregex_tpu.stream import Scanner, compile_pattern


PATTERNS = [
    rb"cat|dog",                  # bounded literals
    rb"a{2,5}b",                  # bounded counted
    rb"\bfoo\b",                  # boundary assertions
    rb"ERROR[^\n]*",              # unbounded tail (log-scan shape)
    rb"a+b",                      # unbounded plus
    rb"(?:ab)*c",                 # sterile-merge adversary
    rb"b(?:aa)*b",                # run parity (unbounded history)
    rb"a*",                       # empty matches everywhere
    rb"x?",                       # empty matches + literals
    rb"\Afoo",                    # anchored: DECLINED after start
    rb"foo$",                     # newline-sensitive end
    rb"(\w{1,5})=(\d{1,4})",      # bounded with captures
]

ALPHABETS = {
    rb"cat|dog": b"catdog x",
    rb"a{2,5}b": b"aab x",
    rb"\bfoo\b": b"foo bar.x",
    rb"ERROR[^\n]*": b"ERO\nRx y",
    rb"a+b": b"aab x",
    rb"(?:ab)*c": b"abc x",
    rb"b(?:aa)*b": b"aab x",
    rb"a*": b"ax",
    rb"x?": b"xy z",
    rb"\Afoo": b"fo x",
    rb"foo$": b"fo\nx",
    rb"(\w{1,5})=(\d{1,4})": b"ab1= x.",
}


def _corpus(pat, n, seed):
    rng = random.Random(seed)
    alpha = ALPHABETS[pat]
    out = bytearray(rng.choice(alpha) for _ in range(n))
    # plant a few literal-ish shapes so every pattern gets real hits
    plants = {
        rb"cat|dog": b"catdog", rb"a{2,5}b": b"aaab",
        rb"\bfoo\b": b" foo ", rb"ERROR[^\n]*": b"ERROR ohno\n",
        rb"a+b": b"aaab", rb"(?:ab)*c": b"ababc",
        rb"b(?:aa)*b": b"baaaab", rb"a*": b"aaa", rb"x?": b"x",
        rb"\Afoo": b"foo", rb"foo$": b"foo\n",
        rb"(\w{1,5})=(\d{1,4})": b"key=1234 ",
    }
    p = plants[pat]
    for _ in range(max(1, n // 300)):
        i = rng.randrange(0, max(1, n - len(p)))
        out[i:i + len(p)] = p
    if pat == rb"\Afoo":
        out[:3] = b"foo" if rng.random() < 0.7 else b"xxx"
    return bytes(out[:n])


def _segmentations(data, rng):
    yield [data]                                   # whole
    yield [data[i:i + 1] for i in range(len(data))]  # byte-at-a-time
    cuts = sorted(rng.sample(range(1, len(data)),
                             min(len(data) - 1, 9)))
    segs, lo = [], 0
    for c in cuts:
        segs.append(data[lo:c])
        lo = c
    segs.append(data[lo:])
    yield segs
    # ragged with empty segments interspersed
    segs2 = []
    for s in segs:
        segs2.append(s)
        segs2.append(b"")
    yield segs2


@pytest.mark.parametrize("pat", PATTERNS, ids=repr)
def test_finditer_stream_matches_whole(pat):
    sc = compile_pattern(pat)
    rng = random.Random(hash(pat) & 0xffff)
    for n, seed in [(700, 1), (3000, 2)]:
        data = _corpus(pat, n, seed)
        expect = list(sc.finditer(data))
        for segs in _segmentations(data, rng):
            got = list(sc.finditer_stream(segs, chunk_len=128,
                                          map_window=512))
            assert got == expect, (pat, n, len(segs))


@pytest.mark.parametrize("pat", PATTERNS, ids=repr)
def test_sub_stream_matches_whole(pat):
    sc = compile_pattern(pat)
    rng = random.Random(hash(pat) & 0xfff)
    repl = b"<$0|$1>"
    for n, seed in [(900, 3)]:
        data = _corpus(pat, n, seed)
        expect, _ = sc.sub(repl, data)
        for segs in _segmentations(data, rng):
            got = b"".join(sc.sub_stream(repl, segs, chunk_len=128,
                                         map_window=512))
            assert got == expect, (pat, n, len(segs))


def test_sub_stream_count_and_callable():
    sc = compile_pattern(rb"\d+")
    data = b"a1 b22 c333 d4444 e5 f66" * 40
    expect, nrep = sc.sub(b"#", data, count=7)
    got = b"".join(sc.sub_stream(b"#", [data[i:i + 13] for i in
                                        range(0, len(data), 13)],
                                 count=7, chunk_len=64,
                                 map_window=256))
    assert got == expect

    def up(rid, ov, window):
        return window[ov[0]:ov[1]].upper()
    sc2 = compile_pattern(rb"[a-z]{2,6}")
    data2 = b"ab cde f ghij " * 30
    expect2, _ = sc2.sub(up, data2)
    got2 = b"".join(sc2.sub_stream(
        up, [data2[i:i + 7] for i in range(0, len(data2), 7)],
        chunk_len=64, map_window=256))
    assert got2 == expect2


def test_finditer_stream_multi_regex():
    pats = [rb"foo", rb"bar\d{1,3}", rb"[A-Z]{2,4}="]
    sc = compile_pattern(pats)
    rng = random.Random(9)
    data = _corpus(rb"cat|dog", 1500, 11)
    data = data.replace(b"cat", b"foo").replace(b"dog", b"bar12")
    data += b" AB= foo bar9 XYZW= tail"
    expect = list(sc.finditer(data))
    assert expect and len({rid for rid, _ in expect}) >= 2
    for segs in _segmentations(data, rng):
        got = list(sc.finditer_stream(segs, chunk_len=128,
                                      map_window=512))
        assert got == expect


def test_finditer_stream_monster_fallback():
    # past the eager DFA budget: the pure Pike re-arm stream
    sc = compile_pattern(rb"foo[a-z]{20,40}z")
    assert sc.dfa is None
    data = (b"foo" + b"abc" * 9 + b"z" + b" filler " * 20) * 8
    expect = list(sc.finditer(data))
    assert expect
    got = list(sc.finditer_stream(
        [data[i:i + 97] for i in range(0, len(data), 97)]))
    assert got == expect
    # sub through the editor fallback
    exp2, _ = sc.sub(b"[$0]", data)
    got2 = b"".join(sc.sub_stream(
        b"[$0]", [data[i:i + 97] for i in range(0, len(data), 97)]))
    assert got2 == exp2


def test_stream_events_device_map():
    """Force the device fire map (the plain walk on the CPU mesh):
    a low DEVICE_THRESHOLD routes whole windows through the
    speculative scan."""
    pats = [rb"dog[0-9]{1,3}", rb"ERROR[^\n]*"]
    for pat in pats:
        ast = None
        sc = compile_pattern(pat, use_device=True)
        sc.DEVICE_THRESHOLD = 1 << 12
        host = compile_pattern(pat)
        rng = random.Random(5)
        data = bytearray(rng.choice(b"dog09 ERx\n ab") # noqa
                         for _ in range(120_000))
        data[5000:5008] = b"dog12 Ex"
        data[60_000:60_011] = b"ERROR boom\n"
        data = bytes(data)
        expect = list(host.finditer(data))
        assert expect
        segs = [data[i:i + 30_000]
                for i in range(0, len(data), 30_000)]
        eng = sc._events_engine(2048, 16 << 10)
        got = []
        for s in segs:
            got.extend(eng.push(s))
        got.extend(eng.push(b"", eof=True))
        assert got == expect, pat
        assert eng.device_chunks > 0, "device map never engaged"


def test_stream_events_memory_bounded():
    """Sparse bounded pattern over a long stream: held bytes must stay
    O(map_window), not O(stream)."""
    sc = compile_pattern(rb"needle")
    eng = sc._events_engine(256, 4 << 10)
    seg = b"x" * (64 << 10)
    peak = 0
    for i in range(8):
        eng.push(seg if i != 4 else seg[:100] + b"needle" + seg[106:])
        peak = max(peak, len(eng.buf))
    eng.push(b"", eof=True)
    assert peak <= (80 << 10), peak
    assert eng.teleports >= 1
