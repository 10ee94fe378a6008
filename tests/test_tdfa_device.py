"""Device tagged-DFA kernel (ops/tdfa_scan.py) vs the Pike oracle.

Runs the plain-JAX tagged walk on the CPU mesh (the same code the GPU
runs).  Exactness is the contract: every certified result must
byte-equal Scanner's Pike-resolved answer ("capture vectors from
device registers byte-equal to Pike").
"""

import numpy as np
import pytest

from sregex_tpu.stream import Scanner, compile_pattern
from sregex_tpu.pike_vm import PikeCtx
from sregex_tpu.tdfa import TdfaTooLarge
from sregex_tpu.ops.tdfa_scan import TdfaSpecTables, tdfa_spec_find


def _oracle(prog, data):
    ctx = PikeCtx(prog)
    rc, _ = ctx.exec(data, True)
    if rc < 0:
        return None
    return rc, [int(v) for v in ctx.ovector]


def _device(sc, data):
    r = sc._tdfa_find(data)
    if r is None:
        return "fallback"
    rc, ov = r
    return None if rc < 0 else (rc, ov)


N = 65536

CASES = [
    ("ab+c", lambda n: (b"xyab" * (n // 4))[: n - 7] + b"abbbczz"),
    ("(a+)(b+)c?", lambda n: (b"qqqq" * (n // 4))[: n - 6] + b"aabbcz"),
    (["foo", "ba(r+)"], lambda n: (b"zzzz" * (n // 4))[: n - 5] + b"obarr"),
    ("^x", lambda n: b"x" + b"y" * (n - 1)),
    ("q\\b", lambda n: (b"mmmm" * (n // 4))[: n - 3] + b"q, "),
    ("z$", lambda n: (b"aaaa" * (n // 4))[: n - 1] + b"z"),
    # > 8 tags / > 8 registers: the second nibble plane (slots 8..12)
    ("(\\d+)-(\\d+)-(\\d+) (\\w+):(\\w+)",
     lambda n: (b";;;;" * (n // 4))[: n - 16] + b"12-34-56 ab:cd;;"),
    ("(\\w+)=(\\w+);(\\w+)=(\\w+)",
     lambda n: (b"- - " * (n // 4))[: n - 12] + b"aa=bb;cc=dd "),
]


@pytest.mark.parametrize("pat,mk", CASES,
                         ids=[repr(p) for p, _ in CASES])
def test_tdfa_device_find_exact(pat, mk):
    sc = compile_pattern(pat)
    try:
        sc._tdfa_spec = TdfaSpecTables(sc.program)
    except TdfaTooLarge:
        pytest.skip("automaton exceeds narrow-kernel budget")
    data = mk(N)
    got = _device(sc, data)
    want = _oracle(sc.program, data)
    # "fallback" is always allowed (exactness by refusal), but for
    # these cases the kernel is expected to certify
    assert got != "fallback", pat
    assert got == want


def test_tdfa_hi_plane_engaged():
    """The 5-group case really exercises the second nibble plane (it
    would previously raise TdfaTooLarge at 8 tags) while staying on
    4-bit codes."""
    sc = compile_pattern("(\\d+)-(\\d+)-(\\d+) (\\w+):(\\w+)")
    t = TdfaSpecTables(sc.program)
    assert t.ntags > 8 and t.nregs > 8, (t.ntags, t.nregs)
    assert t.code_bits == 4
    assert t.t_regsrc.shape[0] == 2 and t.t_csrc.shape[0] == 2
    assert np.asarray(t.t_csrc[1]).any()
    assert np.asarray(t.t_regsrc[1]).any()


def test_tdfa_device_no_match_certified():
    sc = compile_pattern("ab+c")
    sc._tdfa_spec = TdfaSpecTables(sc.program)
    data = b"xyxy" * (N // 4)
    assert _device(sc, data) is None
    assert _oracle(sc.program, data) is None


def test_tdfa_device_window_exceeding_span_falls_back():
    # a match longer than chunk+warmup cannot be certified: registers
    # predate the window and come back BAD -> "fallback", never wrong
    sc = compile_pattern("a+b")
    sc._tdfa_spec = TdfaSpecTables(sc.program)
    data = b"a" * (N - 1) + b"b"
    got = _device(sc, data)
    want = _oracle(sc.program, data)
    assert got in ("fallback", want)
    if got != "fallback":
        assert got == want
    # and the public API stays exact regardless
    old = Scanner.DEVICE_THRESHOLD
    try:
        Scanner.DEVICE_THRESHOLD = 1024
        assert sc.find(data) == want
    finally:
        Scanner.DEVICE_THRESHOLD = old


def test_tdfa_device_scanner_integration():
    # Scanner.find routes through the device kernel when the buffer
    # clears DEVICE_THRESHOLD; result must equal the host path
    sc = compile_pattern("(a+)(b+)c?")
    sc._tdfa_spec = TdfaSpecTables(sc.program)
    data = (b"qqqq" * (N // 4))[: N - 6] + b"aabbcz"
    want = _oracle(sc.program, data)
    old = Scanner.DEVICE_THRESHOLD
    try:
        Scanner.DEVICE_THRESHOLD = 1024
        assert sc.find(data) == want
    finally:
        Scanner.DEVICE_THRESHOLD = old


def test_tdfa_device_tiny_and_empty_inputs():
    sc = compile_pattern("(a+)(b+)")
    sc._tdfa_spec = TdfaSpecTables(sc.program)
    for data in (b"", b"ab", b"zzz", b"xaab"):
        got = _device(sc, data)
        want = _oracle(sc.program, data)
        if got != "fallback":
            assert got == want, data


def test_device_find_no_false_certification_on_spanning_match():
    """Regression: the speculative warmup must NOT rebuild registers
    along the fresh-from-seed trajectory — the chain validation
    proves state CONVERGENCE, not register equality, so a warmup-
    rebuilt (lower-priority) match start could be certified over the
    true pre-window one.  .[X](.+)+[X] over 12 KB with the winner
    spanning nearly the whole corpus returned start 8162 instead of
    Pike's leftmost 1 (caught by tests/core_sweep.py on the real
    conformance suite patterns)."""
    from sregex_tpu.parser import parse
    from sregex_tpu.compiler import compile_regex
    from sregex_tpu.stream import Scanner
    import random
    ast, _ = parse(b".[X](.+)+[X]")
    prog = compile_regex(ast)
    rng = random.Random(1)
    data = bytes(rng.choice(b"X  xx\n") for _ in range(12000))
    host = Scanner(prog, ast=ast)
    dev = Scanner(prog, use_device=True, ast=ast)
    dev.DEVICE_THRESHOLD = 1 << 10
    assert dev.find(data) == host.find(data)
    # and the device TDFA path itself either falls back or agrees
    from sregex_tpu.ops.tdfa_scan import tdfa_spec_find
    r = tdfa_spec_find(dev._tdfa_spec, data)
    exp = host.find(data)
    assert r == "fallback" or (r[0], r[1][:4]) == (exp[0], exp[1][:4])


def test_device_find_chunk_repair_on_speculation_miss():
    """Chunk-entry speculation misses (runs longer than the warmup
    window) no longer force a wholesale fallback: the chunk-wise
    repair decodes trusted chunks from the kernel planes and re-walks
    only the missed ones on the host TDFA — the result stays
    byte-equal to Pike, including inner groups."""
    import random
    from sregex_tpu.parser import parse
    from sregex_tpu.compiler import compile_regex
    from sregex_tpu.ops.tdfa_scan import TdfaSpecTables, tdfa_spec_find
    from sregex_tpu.pike_vm import PikeCtx
    ast, _ = parse(rb"(\w+)@(\w+)")
    prog = compile_regex(ast)
    t = TdfaSpecTables(prog)
    rng = random.Random(4)
    data = bytearray()
    while len(data) < 30000:
        data += bytes(rng.choice(b"ab de ")
                      for _ in range(rng.randrange(50, 300)))
        data += b"x" * rng.randrange(40, 90)   # longer than warmup
    data = bytes(data[:30000])
    at = 17000
    data = data[:at] + b" foo@bar " + data[at + 9:]
    r = tdfa_spec_find(t, data, chunk_len=2048)
    assert r != "fallback"
    ctx = PikeCtx(prog, exact=True)
    rc, _ = ctx.exec(data, True)
    assert (r[0], list(r[1])) == (rc, [int(v) for v in ctx.ovector])
    calm = data.replace(b"@", b" ")
    assert tdfa_spec_find(t, calm, chunk_len=2048) is None


def test_device_find_chunk_repair_on_window_exceeding_start():
    """A winning match whose start precedes its commit chunk's window
    (t0 BAD-tainted) used to abandon the device pass wholesale; the
    chunk-wise repair now resolves it — byte-equal to Pike."""
    import random
    from sregex_tpu.parser import parse
    from sregex_tpu.compiler import compile_regex
    from sregex_tpu.ops.tdfa_scan import TdfaSpecTables, tdfa_spec_find
    from sregex_tpu.pike_vm import PikeCtx
    ast, _ = parse(rb"(\w+)@(\w+)")
    prog = compile_regex(ast)
    t = TdfaSpecTables(prog)
    rng = random.Random(8)
    data = bytearray(rng.choice(b"a  b  ") for _ in range(16384))
    at = 5 * 2048
    # letter run crossing the chunk boundary by 40 bytes, '@' after
    data[at - 40:at + 3] = b"a" * 40 + b"b@c"
    data = bytes(data)
    r = tdfa_spec_find(t, data, chunk_len=2048)
    assert r not in (None, "fallback"), r
    ctx = PikeCtx(prog, exact=True)
    rc, _ = ctx.exec(data, True)
    assert (r[0], list(r[1])) == (rc, [int(v) for v in ctx.ovector])


WIDE_CASES = [
    # patterns whose TDFA exceeds 128 table entries (ROWS > 1): the
    # wide kernel selects the table row by the index's high bits
    (rb"(foo|bar)(baz|qux)x", b"fobarqz x", b"barquxx"),
    (rb"(GET|POST|PUT)x(HTTP|FTP)", b"GEPOSTUFH ", b"PUTxFTP"),
]


@pytest.mark.parametrize("pat,alpha,plant", WIDE_CASES,
                         ids=[repr(p) for p, _, _ in WIDE_CASES])
def test_tdfa_device_wide_rows(pat, alpha, plant):
    """ROWS > 1 capture kernel: one-pass device find byte-equal to
    exact-mode Pike, with the match planted deep in the corpus."""
    import random
    sc = compile_pattern(pat)
    t = TdfaSpecTables(sc.program)
    assert t.rows > 1, (pat, t.nstates * t.ncls)
    rng = random.Random(13)
    data = bytearray(rng.choice(alpha) for _ in range(200_000))
    at = 150_000
    data[at:at + len(plant)] = plant
    data = bytes(data)
    r = tdfa_spec_find(t, data)
    assert r not in (None, "fallback"), r
    want = _oracle(sc.program, data)
    assert (r[0], list(r[1])) == want
    # no-match corpus certifies None
    calm = bytes(rng.choice(alpha[:4]) for _ in range(100_000))
    got = tdfa_spec_find(t, calm)
    want = _oracle(sc.program, calm)
    if got != "fallback":
        assert got == want


def test_tdfa_device_wide_fuzz():
    """Randomized wide-kernel fuzz: random corpora (with planted
    matches at random offsets) through the ROWS>1 one-pass find vs
    the Pike oracle; every certified result must byte-equal it."""
    import random
    pat = rb"(foo|bar)(baz|qux)x"
    sc = compile_pattern(pat)
    t = TdfaSpecTables(sc.program)
    assert t.rows > 1
    rng = random.Random(21)
    certified = 0
    for i in range(8):
        n = rng.randrange(3000, 40000)
        data = bytearray(rng.choice(b"fobarquxz x")
                         for _ in range(n))
        if rng.random() < 0.7:
            at = rng.randrange(0, n - 8)
            data[at:at + 7] = rng.choice([b"fooquxx", b"barbazx"])
        data = bytes(data)
        got = tdfa_spec_find(t, data, chunk_len=2048)
        want = _oracle(sc.program, data)
        if got != "fallback":
            assert got == want, (i, got, want)
            certified += 1
    assert certified >= 4   # the kernel must actually serve most runs


EIGHT_BIT_PAT = rb"(money|parted|fool|kilo|victor|zebra)x([0-9]+)"


def test_tdfa_device_8bit_classes(monkeypatch):
    """ncls > 16 machines ride 8-bit packed data words (cpw=4, the
    untagged tiers' chunk clamp): one-pass device find byte-equal to
    exact-mode Pike."""
    import random
    from sregex_tpu.ops import tdfa_scan
    monkeypatch.setattr(tdfa_scan, "MAX_ENTRIES", 4096)
    sc = compile_pattern(EIGHT_BIT_PAT)
    t = TdfaSpecTables(sc.program)
    assert t.bits == 8 and t.cpw == 4 and t.ncls > 16, \
        (t.bits, t.ncls)
    rng = random.Random(31)
    alpha = b"abcdefghijklmnopqrstuvwxyz0123456789 "
    certified = 0
    for i in range(6):
        n = rng.randrange(4000, 30000)
        data = bytearray(rng.choice(alpha) for _ in range(n))
        if i % 2:
            at = rng.randrange(0, n - 16)
            data[at:at + 12] = b"partedx31415"
        data = bytes(data)
        got = tdfa_spec_find(t, data)
        want = _oracle(sc.program, data)
        if got != "fallback":
            got = None if got is None else (got[0], list(got[1]))
            assert got == want, (i, got, want)
            certified += 1
    assert certified >= 4


BYTECODE_PAT = rb"(\d+)-(\d+)-(\d+)T(\d+):(\d+):(\d+)\.(\d+)"


def test_tdfa_device_bytecode_planes():
    """> 13 tags/regs switch the source planes to 8-bit codes
    (4 slots per int32 plane): a 7-group timestamp pattern (16 tags)
    gets one-pass device captures, byte-equal to exact-mode Pike."""
    import random
    sc = compile_pattern(BYTECODE_PAT)
    t = TdfaSpecTables(sc.program)
    assert t.code_bits == 8 and t.ntags == 16, (t.code_bits, t.ntags)
    assert t.t_csrc.shape[0] == 4    # ceil(16 / 4) byte-code planes
    rng = random.Random(41)
    alpha = b"abc 0123456789-:.T"
    certified = 0
    for i in range(6):
        n = rng.randrange(4000, 30000)
        data = bytearray(rng.choice(alpha) for _ in range(n))
        if i % 2:
            at = rng.randrange(0, n - 30)
            data[at:at + 23] = b"2026-08-19T12:34:56.789"
        data = bytes(data)
        got = tdfa_spec_find(t, data)
        want = _oracle(sc.program, data)
        if got != "fallback":
            got = None if got is None else (got[0], list(got[1]))
            assert got == want, (i, got, want)
            certified += 1
    assert certified >= 4


def test_tdfa_core_bytecode_planes():
    """Hot-core projection with byte-code planes: a sampled core of a
    >13-tag machine stays byte-equal (escapes re-walk in the
    chunk-repair fold)."""
    import random
    from sregex_tpu.ops.tdfa_scan import TdfaCoreTables
    sc = compile_pattern(BYTECODE_PAT)
    rng = random.Random(42)
    alpha = b"abc 0123456789-:.T"
    sample = bytes(rng.choice(alpha) for _ in range(4000)) \
        + b" 2026-08-19T12:34:56.789 " * 2
    t = TdfaCoreTables(sc.program, sample)
    assert t.code_bits == 8 and t.ntags == 16
    for i in range(4):
        n = rng.randrange(4000, 20000)
        data = bytearray(rng.choice(alpha) for _ in range(n))
        if i % 2:
            at = rng.randrange(0, n - 30)
            data[at:at + 23] = b"1999-12-31T23:59:59.001"
        data = bytes(data)
        got = tdfa_spec_find(t, data)
        want = _oracle(sc.program, data)
        if got != "fallback":
            got = None if got is None else (got[0], list(got[1]))
            assert got == want, (i, got, want)


def test_tdfa_core_8bit_classes(monkeypatch):
    """Hot-core tagged projection with 8-bit class words: sampled
    core on a >16-class machine stays byte-equal (escapes re-walk in
    the chunk-repair fold)."""
    import random
    from sregex_tpu.ops import tdfa_scan
    from sregex_tpu.ops.tdfa_scan import TdfaCoreTables
    monkeypatch.setattr(tdfa_scan, "MAX_ENTRIES", 4096)
    sc = compile_pattern(EIGHT_BIT_PAT)
    rng = random.Random(32)
    alpha = b"abcdefghijklmnopqrstuvwxyz0123456789 "
    sample = bytes(rng.choice(alpha) for _ in range(4000)) \
        + b"zebrax77 " * 3
    t = TdfaCoreTables(sc.program, sample)
    assert t.bits == 8 and t.ncls > 16
    for i in range(4):
        n = rng.randrange(4000, 20000)
        data = bytearray(rng.choice(alpha) for _ in range(n))
        if i % 2:
            at = rng.randrange(0, n - 16)
            data[at:at + 12] = b"victorx27182"
        data = bytes(data)
        got = tdfa_spec_find(t, data)
        want = _oracle(sc.program, data)
        if got != "fallback":
            got = None if got is None else (got[0], list(got[1]))
            assert got == want, (i, got, want)


def test_tdfa_device_16bit_code_planes():
    """> 24 tags/regs switch to 16-bit code planes (2 slots per int32
    plane): a 16-group pattern (34 tags) returns the FULL capture
    vector one-pass, byte-equal to exact-mode Pike (VERDICT r3 #6)."""
    import random
    pat = "x(a+)(b)(c)(d)(e)(f)(g)(h)(i)(j)(k)(l)(m)(n)(o)(p+)y"
    sc = compile_pattern(pat)
    t = TdfaSpecTables(sc.program)
    assert t.code_bits == 16 and t.ntags == 34, (t.code_bits, t.ntags)
    assert t.t_csrc.shape[0] == 17     # ceil(34 / 2) 16-bit planes
    rng = random.Random(43)
    alpha = b"abcdefghijklmnop xy"
    certified = 0
    for i in range(5):
        n = rng.randrange(3000, 12000)
        data = bytearray(rng.choice(alpha) for _ in range(n))
        if i % 2 == 0:
            at = rng.randrange(0, n - 40)
            data[at:at + 21] = b"xaaabcdefghijklmnoppy"
        data = bytes(data)
        got = tdfa_spec_find(t, data)
        want = _oracle(sc.program, data)
        if got != "fallback":
            got = None if got is None else (got[0], list(got[1]))
            assert got == want, (i, got, want)
            certified += 1
    assert certified >= 3
