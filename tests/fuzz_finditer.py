"""Adversarial fuzz: device finditer (reverse-map teleport + streamed
Pike windows) vs the host buffered loop — every match (id + full
ovector) must be identical.

The teleport's exactness argument (stream.py) is semantic; this
harness hunts for holes with random pattern/corpus pairs, biased
toward the features that interact with it: assertions at gap edges,
matches straddling chunk boundaries, nullable subexpressions, and
multi-regex sets.

Run directly for a long session:  python tests/fuzz_finditer.py [N]
A bounded smoke runs in pytest (test_fuzz_finditer_smoke).
"""

import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

ATOMS =["a", "b", "c", "x", "ab", "a+", "b*", "c?", "[ab]", "[^c]",
         "(a)", "(ab+)", "a{2,4}", r"\bword", r"ing\b", "^li", r"ne$",
         "(?:ab|ba)", "a.c", "(a+)(b+)?"]


def rand_pattern(rng):
    n = rng.randint(1, 3)
    parts = [rng.choice(ATOMS) for _ in range(n)]
    pat = "".join(parts)
    if rng.random() < 0.25:
        pat = pat + "|" + rng.choice(ATOMS)
    return pat.encode()


def rand_corpus(rng, n):
    alpha = b"abcx word lining\n"
    data = bytearray(rng.choice(alpha) for _ in range(n))
    # plant pattern-ish runs at chunk-boundary-straddling offsets
    for _ in range(rng.randint(0, 4)):
        at = rng.randrange(max(1, n - 30))
        data[at:at + 10] = b"aabbc word"[:10]
    # long single-char runs (past the kernels' warmup windows): these
    # force chunk-entry speculation misses, exercising the repair
    # folds and the TDFA chunk repair
    for _ in range(rng.randint(0, 3)):
        at = rng.randrange(max(1, n - 200))
        data[at:at + 150] = bytes([rng.choice(b"ax ")]) * 150
    return bytes(data)


def one_case(rng, scanner_cls, parse, parse_multi, compile_regex):
    if rng.random() < 0.25:
        k = rng.randint(2, 3)
        pats = [rand_pattern(rng) for _ in range(k)]
        try:
            ast, _ = parse_multi(pats)
        except Exception:
            return None
    else:
        try:
            ast, _ = parse(rand_pattern(rng))
        except Exception:
            return None
    try:
        prog = compile_regex(ast)
        host = scanner_cls(prog, ast=ast)
        dev = scanner_cls(prog, use_device=True, ast=ast)
    except Exception:
        return None
    dev.DEVICE_THRESHOLD = 1 << 10
    n = rng.choice([1500, 4000, 9000])
    data = rand_corpus(rng, n)
    exp = list(host.finditer(data))
    got = list(dev.finditer(data))
    assert got == exp, (ast, data[:80], len(exp), len(got),
                        exp[:3], got[:3])
    # find (TDFA/spec device path vs host reverse-scan) and scan
    # (device boundary + host id lookup vs native) ride along
    assert dev.find(data) == host.find(data), (ast, data[:80])
    assert dev.scan(data) == host.scan(data), (ast, data[:80])
    return True


def run(iters, seed=0):
    from sregex_tpu.parser import parse, parse_multi
    from sregex_tpu.compiler import compile_regex
    from sregex_tpu.stream import Scanner
    rng = random.Random(seed)
    ran = 0
    for i in range(iters):
        if one_case(rng, Scanner, parse, parse_multi, compile_regex):
            ran += 1
    return ran


if __name__ == "__main__":
    # standalone runs use the virtual CPU mesh: per-pattern shapes
    # would otherwise compile one device program each
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    ran = run(iters, seed=random.randrange(1 << 30))
    print("fuzz_finditer: %d/%d cases ran, all equal" % (ran, iters))
