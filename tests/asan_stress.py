"""Differential stress of the native C++ engines under ASAN (run via
`make asan`; the analog of the reference's valgrind test mode).
Exercises streaming exec, captures, multi-regex, prefilter, and the
DFA scanner against the Python oracle."""
import os, random, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sregex_tpu import native_build
_asan = os.path.join(native_build.BUILD_DIR, "..", "asan")
if os.path.exists(os.path.join(_asan, "libsrepike_asan.so")):
    for src, lib in (("sre_pike.cpp", "libsrepike_asan.so"),
                     ("sre_host.cpp", "libsrehost_asan.so"),
                     ("sre_tdfa.cpp", "libsretdfa_asan.so")):
        native_build.OVERRIDES[src] = os.path.join(_asan, lib)

from sregex_tpu import parse, parse_multi, compile_regex
from sregex_tpu.pike_vm import PikeCtx
from sregex_tpu.native_pike import NativePikeCtx
from sregex_tpu.native import NativeDfa
from sregex_tpu.dfa import build_dfa

pats = ["a|(ab)", "(a*)*", r"\b\w+\b", "(a)(b(c))", "a??b*?c+?",
        "x{0,3}y", "$", "^.*$", r"\d+(\.\d+)?", "(?:ab|cd)+"]
rng = random.Random(1)
for pat in pats:
    ast, ncaps = parse(pat)
    prog = compile_regex(ast)
    size = 2 * (ncaps + 1)
    for trial in range(8):
        data = bytes(rng.choice(b"abcxy1. \n_") for _ in
                     range(rng.choice([0, 1, 7, 50, 200])))
        p = PikeCtx(prog, [-1] * size)
        n = NativePikeCtx(prog, ovecsize=size)
        for i in range(len(data)):
            p.exec(data[i:i + 1], False, True)
            n.exec(data[i:i + 1], False, True)
        prc, _ = p.exec(b"", True, True)
        nrc, _ = n.exec(b"", True, True)
        assert prc == nrc, (pat, data, prc, nrc)
        assert list(p.ovector) == [int(v) for v in n.ovector], (pat, data)
    dfa = build_dfa(prog)
    nd = NativeDfa(dfa)
    nd.scan_first(b"abcabc" * 200, 0)
    nd.count(b"abcabc" * 200, 0)
    nd.transfer(b"xyz1." * 50)

# multi-regex
ast, ncaps = parse_multi([b"abcd", b"bc", b"(x+)y"])
prog = compile_regex(ast)
size = 2 * (ncaps + 1)
for data in (b"abcd", b"abce", b"xxxy", b"zzz"):
    p = PikeCtx(prog, [-1] * size)
    n = NativePikeCtx(prog, ovecsize=size)
    prc, _ = p.exec(data, True)
    nrc, _ = n.exec(data, True)
    assert prc == nrc and list(p.ovector) == [int(v) for v in n.ovector]

# TDFA walker (findall re-arm loop, batch resume, empty matches)
from sregex_tpu.native_tdfa import NativeTdfa
from sregex_tpu.tdfa import TdfaTooLarge
for pat in ["a|(ab)", r"\b\w+\b", "(a)(b(c))?", "a*", "(?:ab|cd)+",
            ["ab", r"(\d+)", "c"]]:
    if isinstance(pat, list):
        ast, _ = parse_multi([p.encode() if isinstance(p, str) else p
                              for p in pat])
    else:
        ast, _ = parse(pat)
    prog = compile_regex(ast)
    try:
        w = NativeTdfa(prog)
    except TdfaTooLarge:
        continue
    for trial in range(6):
        data = bytes(rng.choice(b"abcxy1. \n_") for _ in
                     range(rng.choice([0, 3, 40, 300])))
        rows = w.findall(data)
        for b in w._batches(data, batch=1, max_batch=3):
            pass

print("ASAN differential stress OK")
