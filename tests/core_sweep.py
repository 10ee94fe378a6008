"""Standalone device-tier sweep over the conformance corpus patterns.

For every unique single-regex pattern in the reference suite that
compiles, run Scanner.count/scan (use_device, low threshold — so the
Scanner's production tier selection runs: pair/narrow/wide/big,
adaptive core, or lazy core) on random data biased toward the
pattern's own bytes, and compare against the host oracle (NativeDfa,
or LazyDfa when past the eager budget).  This cross-checks the WHOLE
tier-dispatch stack on real-suite patterns rather than hand-picked
ones.

Without the reference checkout (tblocks.REF_T_DIR) the sweep runs a
fixed list of conformance-style patterns kept here (FALLBACK_PATTERNS).

Usage: python tests/core_sweep.py [N=150] [seed]
"""

import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
# the sweep lowers DEVICE_THRESHOLD to 1 KiB, which would trigger the
# mid-band tier A/B (5 timed kernel reps) for every eligible pattern;
# the sweep's job is dispatch EXACTNESS — the A/B has its own
# coverage (tests/test_tier_ab.py, smoke case 15)
os.environ.setdefault("SREGEX_TIER_AB", "0")
import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")


# conformance-style patterns (literals, classes, anchors, word
# boundaries, lazy and counted repetition, alternation, captures,
# multi-byte machines past the narrow and wide tiers) for machines
# without the reference suite
FALLBACK_PATTERNS = [
    b"a", b"ab", b"abc", b"a|b", b"a|(ab)", b"a*", b"a+b", b"a?b",
    b"(a|b)*c", b"[a-z]+", b"[^a]b", rb"\d+", rb"\w+\s+\w+",
    b"^abc", b"abc$", rb"\bfoo\b", b"a{2,3}", b"a{3}", b"(ab){2,}",
    b"x{0,3}y", b"(a*)*", b"(a|ab)(c|bcd)(d*)", b"[0-9a-f]{2,8}",
    b".*abc", b"a.c", b"(?:a|b)aa(?:aa|bb)cc(?:a|b)", rb"\Aab",
    rb"ab\z", rb"(\w+)@(\w+)", b"a{60}b", b"(?:ab|ba){8,20}c",
    b"b(?:aa)*b", rb"\d+(\.\d+)?", b"x*y*z*", b"(foo|bar|baz)+",
    b"[aeiou]{2}", b"a+?b", b"a*?c", b"(a)(b(c))", rb"\S+",
    b"word (?:[a-zA-Z0-9]+ ){0,10}otherword",
    b"(x|y|z[QW]){1,5}(longish|loquatious)",
]


def suite_patterns():
    """Unique single-regex patterns of the reference suite, or
    FALLBACK_PATTERNS when the suite is not on this machine."""
    from tblocks import REF_T_DIR, iter_suite, resolve_section, \
        PerlOracle
    if not os.path.isdir(REF_T_DIR):
        return list(FALLBACK_PATTERNS)
    oracle = PerlOracle()
    seen = set()
    pats = []
    for path, blocks in iter_suite():
        for b in blocks:
            try:
                re_val = resolve_section(b, "re", oracle)
            except Exception:
                continue
            if not isinstance(re_val, bytes) or re_val in seen:
                continue
            seen.add(re_val)
            pats.append(re_val)
    oracle.close()
    return pats


def pattern_alphabet(pat):
    """Bytes likely to drive the automaton + some junk."""
    lits = bytes(sorted({b for b in pat
                         if bytes([b]).isalnum()})) or b"ab"
    return lits + b"  xx\n"


def run(limit=150, seed=7, verbose=True, multi_every=5):
    """Every ``multi_every``-th case additionally fuses the NEXT 2-3
    suite patterns into one multi-regex program and checks the
    device scan's (regex_id, end) + count against the oracle."""
    from sregex_tpu.parser import parse, parse_multi
    from sregex_tpu.compiler import compile_regex
    from sregex_tpu.stream import Scanner
    from sregex_tpu.native import NativeDfa

    pats = suite_patterns()
    rng = random.Random(seed)
    rng.shuffle(pats)

    ran = skipped = 0
    fails = []
    for pi, pat in enumerate(pats):
        if ran >= limit:
            break
        if ran and ran % 40 == 0:
            # free accumulated XLA:CPU executables: hundreds of
            # compiles in one process exhaust host RAM
            # (the full 708-pattern run died in LLVM at ~350 without
            # this — the same class conftest handles per test module)
            import gc
            import jax
            jax.clear_caches()
            gc.collect()
        try:
            if multi_every and pi % multi_every == 0:
                group = [pat] + [p for p in pats[pi + 1:pi + 3]]
                ast, _ = parse_multi(group)
                pat = b" | ".join(group)
            else:
                ast, _ = parse(pat)
            prog = compile_regex(ast)
        except Exception:
            skipped += 1
            continue
        sc = Scanner(prog, use_device=True, ast=ast)
        sc.DEVICE_THRESHOLD = 1 << 10
        alpha = pattern_alphabet(pat)
        data = bytes(rng.choice(alpha) for _ in range(12000))
        if sc.dfa is not None:
            nat = NativeDfa(sc.dfa)
            exp_c, exp_st = nat.count(data, 0)
            exp_total = exp_c + int(sc.dfa.match_eof[exp_st])
            exp_f, exp_s = nat.scan_first(data, 0)
            exp_scan = ((sc.dfa.id_at(exp_s, data[exp_f]), exp_f)
                        if exp_f >= 0 else
                        ((int(sc.dfa.match_eof_id[exp_st]), len(data))
                         if sc.dfa.match_eof[exp_st] else None))
        else:
            from sregex_tpu.dfa import LazyDfa
            lz = LazyDfa(prog)
            exp_c, exp_st = lz.count(data, 0)
            exp_total = exp_c + int(lz.match_eof(exp_st))
            exp_f, exp_s = lz.scan_first(data, 0)
            rid_eof = lz.match_eof_id(exp_st)
            exp_scan = ((lz.id_at(exp_s, data[exp_f]), exp_f)
                        if exp_f >= 0 else
                        ((rid_eof, len(data)) if rid_eof >= 0
                         else None))
        try:
            got_total = sc.count(data)
            got_scan = sc.scan(data)
            host = Scanner(prog, ast=ast)
            got_find = sc.find(data)
            exp_find = host.find(data)
        except Exception as e:
            fails.append((pat, "exception", repr(e)))
            continue
        if got_total != exp_total or got_scan != exp_scan \
                or got_find != exp_find:
            fails.append((pat, (got_total, exp_total),
                          (got_scan, exp_scan),
                          (got_find, exp_find)))
        ran += 1
        if verbose and ran % 25 == 0:
            print("...%d patterns, %d fails" % (ran, len(fails)),
                  flush=True)
    print("core_sweep: %d patterns checked, %d skipped, %d FAILURES"
          % (ran, skipped, len(fails)))
    for f in fails[:10]:
        print("  FAIL:", f)
    return ran, fails


def main():
    limit = int(sys.argv[1]) if len(sys.argv) > 1 else 150
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 7
    _, fails = run(limit, seed)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
