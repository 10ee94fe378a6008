"""GPU smoke run: the device scan path end to end at the benchmark's size.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --chips 4    # only the mesh paths, four GPUs

One process, strict device mode (SREGEX_STRICT_DEVICE=1: a device tier
that fails raises instead of falling back to the host engines).  Phases
on one card, each with its own output lines:

  1. card and environment;
  2. the chunk-walk kernel (ops/scan_kernel.py) against the plain
     reference, bit for bit, at the benchmark's widths;
  3. timing of kernel and plain version, walk alone and end to end,
     in turns;
  4. the main path: Scanner.scan / Scanner.count on both benchmark
     workloads (1920 MB each) against the native engine;
  5. every other device tier once at small size against its host
     oracle.

The last line of standard output is one JSON object
{"ok": true, "device": {"platform", "kind", "count"}}.  Any failure, or
a machine where JAX finds no accelerator, exits non-zero without it.
"""

import argparse
import functools
import json
import os
import sys
import time

os.environ["SREGEX_STRICT_DEVICE"] = "1"

MB = 1920
HOST_TIERS = ("native", "lazy")


def log(msg):
    print("chip_smoke: %s" % msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        log("== %s" % self.name)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log("ok %s (%.1fs)" % (self.name, time.time() - self.t0))


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def device_tier(sc, expect=None):
    """Assert the last scan was served by a device tier (and by
    ``expect`` when given); returns its name."""
    st = sc.stats()
    check(st is not None and st.tier not in HOST_TIERS,
          "host engine served the scan: %r" % (st,))
    if expect is not None:
        check(st.tier == expect, "tier %s, expected %s" % (st.tier, expect))
    return st.tier


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def readback(out):
    """Block on every array of ``out`` and read one value back."""
    import jax
    import numpy as np
    leaves = jax.block_until_ready(jax.tree_util.tree_leaves(out))
    return int(np.asarray(leaves[0]).reshape(-1)[0]) if leaves else 0


def time_call(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        readback(fn())
        out.append(time.perf_counter() - t0)
    return out


def in_turns(fns, rounds=2):
    """Time {name: fn} alternately (a, b, b, a per round); every fn is
    called once first to compile.  Returns {name: [seconds...]}."""
    for fn in fns.values():
        readback(fn())
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(rounds):
        order = names + names[::-1]
        for k in order:
            times[k] += time_call(fns[k], 1)
    return times


def fmt_times(times, nbytes=None):
    parts = []
    for k, ts in times.items():
        best = min(ts)
        s = "%s best %.3f ms (%s)" % (
            k, best * 1e3, ", ".join("%.3f" % (t * 1e3) for t in ts))
        if nbytes:
            s += " = %.2f GB/s" % (nbytes / best / 1e9)
        parts.append(s)
    return "; ".join(parts)


def walk_planes(impl, tables, data, s0, j0, flags=None, COUNT=True):
    u = getattr(tables, "bpu", 1)
    fn = _walk_jit(impl, tables.warmup // u, tables.cpw, tables.bits,
                   COUNT)
    return fn(data, s0, j0 // u if u > 1 else j0, tables.table, flags)


@functools.lru_cache(maxsize=None)
def _walk_jit(impl, W, CPW, BITS, COUNT):
    import jax
    from sregex_tpu.ops.scan_kernel import walk
    return jax.jit(functools.partial(walk, W=W, CPW=CPW, BITS=BITS,
                                     COUNT=COUNT, impl=impl))


def entry_planes(tables, B, seed=None):
    """Chunk-0 entry planes as the scan drivers build them, or (seed
    given) random valid states and freeze points for every stream."""
    import jax.numpy as jnp
    import numpy as np
    from sregex_tpu.ops.pallas_scan import GROUPS, _entry_planes
    if seed is None:
        return _entry_planes(jnp.int32(0), jnp.int32(tables.warmup), B=B)
    rng = np.random.default_rng(seed)
    shape = (B, GROUPS, 8, 128)
    s0 = rng.integers(0, tables.nstates, size=shape) * tables.ncls
    j0 = rng.integers(0, tables.warmup + 1, size=shape)
    return jnp.asarray(s0, jnp.int32), jnp.asarray(j0, jnp.int32)


def same_planes(a, b):
    import numpy as np
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def build_workloads(mb):
    """Both benchmark workloads: scanners, corpora, native oracles."""
    from sregex_tpu import parse_multi, compile_regex
    from sregex_tpu.stream import Scanner, compile_pattern
    from sregex_tpu import workloads as wl
    t0 = time.time()
    w = {}
    sc = compile_pattern(wl.HEADLINE_PATTERN, use_device=True)
    corpus = wl.headline_corpus(mb)
    first, st = sc._native.scan_first(corpus, 0)
    k, kst = sc._native.count(corpus, 0)
    check(first > 0, "no planted match")
    w["headline"] = dict(sc=sc, corpus=corpus, first=first,
                         count=k + int(sc.dfa.match_eof[kst]))
    ast, _ = parse_multi(wl.multi_patterns())
    msc = Scanner(compile_regex(ast), use_device=True, ast=ast)
    mcorpus = wl.multi_corpus(mb)
    mfirst, _ = msc._native.scan_first(mcorpus, 0)
    k, kst = msc._native.count(mcorpus, 0)
    w["multi"] = dict(sc=msc, corpus=mcorpus, first=mfirst,
                      count=k + int(msc.dfa.match_eof[kst]))
    log("workloads: headline %d bytes (S=%d, ncls=%d), multi %d bytes "
        "(%d patterns, S=%d, ncls=%d), native oracles in %.1fs"
        % (len(corpus), sc.dfa.nstates, sc.dfa.nclasses, len(mcorpus),
           len(wl.MULTI_WORDS), msc.dfa.nstates, msc.dfa.nclasses,
           time.time() - t0))
    return w


# ---------------------------------------------------------------- phases


def phase_env():
    import jax
    from sregex_tpu import devenv
    cache = devenv.compile_cache()
    platform, kind, count = devenv.accelerator()
    card = devenv.card_line()
    log("card: %s" % card)
    log("jax %s, devices %s x%d (%s), compile cache %s"
        % (jax.__version__, kind, count, platform, cache))
    from sregex_tpu.native_build import load_all
    for name, lib in load_all().items():
        check(lib is not None, "native library %s failed to build" % name)
        log("native %s: %s" % (name, os.path.basename(lib._name)))
    return dict(platform=platform, kind=kind, count=count, card=card)


def phase_kernels(w, kernel="triton"):
    """K1 at the headline shape (narrow table, 4-bit) and in pair
    units; K2/K3 on the multi workload's 12,447-entry full machine
    (8-bit packing) with gated blocks on and off."""
    import jax.numpy as jnp
    import numpy as np
    from sregex_tpu.ops.pallas_pair import SpecTablesPair
    from sregex_tpu.ops.pallas_big import SpecTablesBig
    from sregex_tpu.ops.pallas_scan import SpecTables
    from sregex_tpu.dfa import build_dfa
    from sregex_tpu import parse, compile_regex
    out = {}

    h = w["headline"]
    spec = h["sc"]._spec
    check(isinstance(spec, SpecTables), "headline tier %r" % (spec,))
    h["prepared"] = h["sc"].prepare(h["corpus"])
    data, C, K, J, B = h["prepared"].for_tables(spec)
    log("K1 narrow: table %d entries (S*ncls=%d), %d-bit, data %s"
        % (spec.table.size, spec.nstates * spec.ncls, spec.bits,
           data.shape))
    for COUNT in (False, True):
        for seed in (None, 7):
            s0, j0 = entry_planes(spec, B, seed)
            a = walk_planes("plain", spec, data, s0, j0, COUNT=COUNT)
            b = walk_planes(kernel, spec, data, s0, j0, COUNT=COUNT)
            check(same_planes(a, b), "K1 narrow differs (COUNT=%s, "
                  "planes %s)" % (COUNT, seed))
            log("K1 narrow COUNT=%s planes=%s: bit-identical (fm sum %d)"
                % (COUNT, "random" if seed else "entry",
                   int(np.asarray(a[1]).sum())))
    out["headline"] = (spec, data, B)

    ast, _ = parse("ab")
    pair = SpecTablesPair(build_dfa(compile_regex(ast)), narrow_only=True)
    raw = jnp.asarray(np.frombuffer(h["corpus"][:512 << 20], np.uint8))
    from sregex_tpu.ops.prep import prepare_auto
    pdata, _, _, _, pB = prepare_auto(pair, raw, 2048)
    for COUNT in (False, True):
        s0, j0 = entry_planes(pair, pB, 3)
        a = walk_planes("plain", pair, pdata, s0, j0, COUNT=COUNT)
        b = walk_planes(kernel, pair, pdata, s0, j0, COUNT=COUNT)
        check(same_planes(a, b), "K1 pair differs (COUNT=%s)" % COUNT)
    log("K1 pair units ('ab', %d pair classes, data %s): bit-identical"
        % (pair.ncls, pdata.shape))
    del raw, pdata

    m = w["multi"]
    full = m["sc"]._spec
    check(isinstance(full, SpecTablesBig) and full.bits == 8,
          "multi full machine tier %r" % (full,))
    m["prepared"] = m["sc"].prepare(m["corpus"])
    fdata, fC, fK, fJ, fB = m["prepared"].for_tables(full)
    log("K2 big: %d live entries (table %d), %d-bit, data %s"
        % (full.nstates * full.ncls, full.table.size, full.bits,
           fdata.shape))
    s0, j0 = entry_planes(full, fB, 11)
    ref = walk_planes("plain", full, fdata, s0, j0)
    got = walk_planes(kernel, full, fdata, s0, j0)
    check(same_planes(ref, got), "K2 big differs")
    log("K2 big COUNT: bit-identical (fm sum %d)"
        % int(np.asarray(ref[1]).sum()))
    for name, flags in (("all on", np.ones(fB, np.int32)),
                        ("alternate", np.arange(fB, dtype=np.int32) % 2),
                        ("all off", np.zeros(fB, np.int32))):
        flags = jnp.asarray(flags)
        a = walk_planes("plain", full, fdata, s0, j0, flags)
        b = walk_planes(kernel, full, fdata, s0, j0, flags)
        check(same_planes(a, b), "K3 gated differs (%s)" % name)
        if name == "all on":
            check(same_planes(a, ref), "gated all-on != ungated")
    log("K3 gated (all on / alternate / all off): bit-identical")
    out["multi"] = (full, fdata, fB)
    return out


def phase_timing(w, shapes, kernel="triton", reps=2):
    """Walk alone and end to end, kernel and plain in turns."""
    from sregex_tpu.ops.scan_kernel import forced_implementation
    res = {}
    spec, data, B = shapes["headline"]
    s0, j0 = entry_planes(spec, B)
    nbytes = len(w["headline"]["corpus"])
    t = in_turns({
        "plain": lambda: walk_planes("plain", spec, data, s0, j0,
                                     COUNT=False),
        kernel: lambda: walk_planes(kernel, spec, data, s0, j0,
                                    COUNT=False)}, rounds=reps)
    log("walk K1 headline (scan mode): %s" % fmt_times(t, nbytes))
    res["walk_headline"] = t

    full, fdata, fB = shapes["multi"]
    s0, j0 = entry_planes(full, fB)
    mbytes = len(w["multi"]["corpus"])
    t = in_turns({
        "plain": lambda: walk_planes("plain", full, fdata, s0, j0),
        kernel: lambda: walk_planes(kernel, full, fdata, s0, j0)},
        rounds=reps)
    log("walk K2 multi full machine (count): %s" % fmt_times(t, mbytes))
    res["walk_big"] = t

    def e2e(name, api, impl):
        d = w[name]

        def run():
            with forced_implementation(impl):
                return getattr(d["sc"], api)(d["corpus"],
                                             prepared=d["prepared"])
        return run

    for name, api in (("headline", "scan"), ("multi", "count")):
        t = in_turns({"plain": e2e(name, api, "plain"),
                      kernel: e2e(name, api, kernel)}, rounds=reps)
        log("end to end %s %s: %s"
            % (name, api, fmt_times(t, len(w[name]["corpus"]))))
        res["e2e_" + name] = t
    return res


def phase_main(w, reps=3):
    h = w["headline"]
    sc, corpus = h["sc"], h["corpus"]
    for api in ("scan", "count"):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = getattr(sc, api)(corpus, prepared=h["prepared"])
            ts.append(time.perf_counter() - t0)
            if api == "scan":
                check(r == (0, h["first"]),
                      "headline scan %r != %r" % (r, (0, h["first"])))
            else:
                check(r == h["count"],
                      "headline count %r != %r" % (r, h["count"]))
        tier = device_tier(sc, "SpecTables")
        log("headline %s = %r (tier %s): best %.3f ms = %.2f GB/s"
            % (api, r, tier, min(ts) * 1e3,
               len(corpus) / min(ts) / 1e9))
    m = w["multi"]
    sc, corpus = m["sc"], m["corpus"]
    for api in ("count", "scan"):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = getattr(sc, api)(corpus, prepared=m["prepared"])
            ts.append(time.perf_counter() - t0)
            if api == "scan":
                check(r is not None and r[1] == m["first"],
                      "multi scan %r != end %r" % (r, m["first"]))
            else:
                check(r == m["count"],
                      "multi count %r != %r" % (r, m["count"]))
        tier = device_tier(sc, "CoreTables")
        st = sc.stats()
        log("multi %s = %r (tier %s, %d/%d chunks repaired on host): "
            "best %.3f ms = %.2f GB/s"
            % (api, r, tier, st.repaired, st.chunks, min(ts) * 1e3,
               len(corpus) / min(ts) / 1e9))
    log("peak device bytes in use: %s" % peak_bytes())


def rand_corpus(seed, alphabet, mb, plants=()):
    import numpy as np
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    data = bytearray(a[rng.integers(0, len(a), size=mb << 20)].tobytes())
    for frac, s in plants:
        pos = int(len(data) * frac)
        data[pos:pos + len(s)] = s
    return bytes(data)


def phase_tiers():
    """One pattern per remaining device tier at small size, each
    against its host oracle, with the serving tier asserted."""
    import re
    from sregex_tpu import parse, parse_multi, compile_regex
    from sregex_tpu.dfa import build_dfa
    from sregex_tpu.native import NativeDfa
    from sregex_tpu.stream import Scanner, compile_pattern
    from sregex_tpu.ops import tdfa_scan
    from sregex_tpu.ops.tdfa_scan import TdfaSpecTables

    def count_scan(name, pattern, alphabet, plant, expect, env=None):
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            ast, _ = parse(pattern)
            sc = Scanner(compile_regex(ast), use_device=True, ast=ast)
            data = rand_corpus(len(name), alphabet, 8, [(0.7, plant)])
            k, st = sc._native.count(data, 0)
            got = sc.count(data)
            check(got == k + int(sc.dfa.match_eof[st]),
                  "%s count %r" % (name, got))
            tier = device_tier(sc, expect)
            exp_f, _ = sc._native.scan_first(data, 0)
            got_s = sc.scan(data)
            check(exp_f < 0 or (got_s is not None and got_s[1] == exp_f),
                  "%s scan %r != %r" % (name, got_s, exp_f))
            device_tier(sc)
            log("tier %s: %s count %d, first %d" % (name, tier, got,
                                                    exp_f))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    count_scan("pair-narrow", "ab", b"acb x", b"ab", "SpecTablesPair")
    count_scan("byte-narrow", "(?:a|b)aa(?:aa|bb)cc(?:a|b)", b"abc x",
               b"baaaacca", "SpecTables",
               env={"SREGEX_PAIR": "0", "SREGEX_CORE": "0"})
    count_scan("narrow-3bit", "(?:a|b)aa(?:aa|bb)cc(?:a|b)", b"abc x",
               b"baaaacca", "SpecTables",
               env={"SREGEX_PACK_BITS": "3", "SREGEX_PAIR": "0",
                    "SREGEX_CORE": "0"})
    count_scan("wide-4bit", "(?:ab|ba){8,20}c", b"aabb c",
               b"c" + b"ab" * 12 + b"c", "SpecTablesWide",
               env={"SREGEX_CORE": "0"})
    count_scan("affine", "a{60,120}b", b"aab x", b"x" + b"a" * 80 + b"b",
               "SpecTablesAffine", env={"SREGEX_CORE": "0"})

    words = [w.encode() for w in (
        "alpha bravo charlie delta echo foxtrot golf hotel india juliet "
        "kilo lima mike november oscar papa quebec romeo").split()]
    ast, _ = parse_multi(words)
    os.environ["SREGEX_CORE"] = "0"
    try:
        sc = Scanner(compile_regex(ast), use_device=True, ast=ast)
        data = rand_corpus(4, b"abcdefgh ", 8,
                           [(0.5, b" kilo "), (0.8, b" romeo ")])
        k, st = sc._native.count(data, 0)
        check(sc.count(data) == k + int(sc.dfa.match_eof[st]),
              "wide-8bit count")
        tier = device_tier(sc)
        check(sc._spec.bits == 8, "wide-8bit packing %d" % sc._spec.bits)
        log("tier wide-8bit-multi: %s" % tier)
    finally:
        os.environ.pop("SREGEX_CORE", None)

    from sregex_tpu.ops.pallas_big import SpecTablesBig
    from sregex_tpu.ops.pallas_scan import spec_count_bytes
    from sregex_tpu.ops.pallas_core import CoreTables, core_count_bytes
    ast, _ = parse(b"(x|y|z[QW]){1,5}(longish|loquatious)")
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    big = SpecTablesBig(dfa)
    native = NativeDfa(dfa)
    data = rand_corpus(5, b"xyzQWlong ", 8, [(0.6, b"zQxylongish")])
    exp = native.count(data, 0)[::-1]
    check(spec_count_bytes(big, data) == exp, "big tier count")
    ct = CoreTables(dfa, data[:1 << 20])
    check(core_count_bytes(ct, data) == exp, "core tier count")
    log("tier big (%d entries) and core: count %d" % (
        dfa.nstates * dfa.nclasses, exp[1]))

    sc = compile_pattern(rb"b(?:aa)*b", use_device=True)
    data = bytearray(b"a" * (8 << 20))
    data[4 << 20:(4 << 20) + 6] = b"baaaab"
    data = bytes(data)
    k, st = sc._native.count(data, 0)
    sc._phi_active = True
    check(sc._phi_tables() is not None, "phi tables")
    check(sc.count(data) == k + int(sc.dfa.match_eof[st]), "phi count")
    device_tier(sc, "PhiTables")
    log("tier phi: count %d" % k)

    def find_case(name, pat, alphabet, plant, groups, setup=None):
        sc = compile_pattern(pat, use_device=True)
        if setup:
            setup(sc)
        data = rand_corpus(len(name), alphabet, 8, [(0.7, plant)])
        got = sc.find(data)
        m = re.search(pat, data)
        check(got is not None and m is not None, "%s find" % name)
        for gi in range(groups + 1):
            check((got[1][2 * gi], got[1][2 * gi + 1]) == m.span(gi),
                  "%s group %d: %r != %r" % (name, gi, got[1], m.span(gi)))
        log("find %s: span %r" % (name, m.span()))

    find_case("tdfa", rb"(\w+)@(\w+)", b"ab @. ", b" user@host ", 2)

    def own_tables(sc):
        sc._tdfa_spec = TdfaSpecTables(sc.program)

    find_case("tdfa-wide", rb"(GET|POST|PUT)x(HTTP|FTP)", b"GEPOSTUFH ",
              b" PUTxFTP ", 2, own_tables)
    find_case("tdfa-hi-plane", rb"([a-z]{2,12})=([0-9]{2,8})",
              b"xy09=. ", b" key=1234 ", 2, own_tables)
    find_case("tdfa-bytecode",
              rb"(\d+)-(\d+)-(\d+)T(\d+):(\d+):(\d+)\.(\d+)",
              b"abc 0189-:.T ", b" 2026-08-19T12:34:56.789 ", 7,
              own_tables)
    find_case("tdfa-16bit",
              rb"x(a+)(b)(c)(d)(e)(f)(g)(h)(i)(j)(k)(l)(m)(n)(o)(p+)y",
              b"abcdefghijklmnop xy", b"xaaabcdefghijklmnoppy", 16,
              own_tables)

    def eight_bit(sc):
        saved = tdfa_scan.MAX_ENTRIES
        tdfa_scan.MAX_ENTRIES = 4096
        try:
            own_tables(sc)
        finally:
            tdfa_scan.MAX_ENTRIES = saved
        check(sc._tdfa_spec.bits == 8, "tdfa 8-bit packing")

    find_case("tdfa-8bit", rb"(money|parted|fool|kilo|victor|zebra)x([0-9]+)",
              b"abcdefgz 0189 ", b" zebrax77 ", 2, eight_bit)

    pat = b"(?:a|b)aa(?:aa|bb)cc(?:a|b)"
    sc = compile_pattern(pat, use_device=True)
    data = rand_corpus(9, b"ab x", 8, [(0.2, b"baaaacca"),
                                       (0.8, b"xaaabbccb")])
    idx = sc.make_index(data)
    spans = [(m[1][0], m[1][1]) for m in sc.finditer(data, index=idx)]
    check(spans == [m.span() for m in re.finditer(pat, data)],
          "finditer via make_index")
    log("finditer via make_index: %d matches" % len(spans))

    data = rand_corpus(10, b"abc x", 32, [(0.5, b"baaaacca")])
    segs = [data[i:i + (5 << 20)] for i in range(0, len(data), 5 << 20)]
    exp = sc.count(data)
    check(sc.count_stream(iter(segs)) == exp, "count_stream")
    device_tier(sc)
    log("count_stream: %d (tier %s)" % (exp, sc.stats().tier))

    epat = rb"ERROR[^\n]*"
    esc = compile_pattern(epat, use_device=True)
    data = rand_corpus(11, b"log lines go here\n", 32,
                       [(f, b"ERROR boom %d\n" % i)
                        for i, f in enumerate((0.1, 0.4, 0.7, 0.95))])
    segs = [data[i:i + (8 << 20)] for i in range(0, len(data), 8 << 20)]
    evs = [(ov[0], ov[1]) for _, ov in esc.finditer_stream(iter(segs))]
    check(evs == [m.span() for m in re.finditer(epat, data)],
          "finditer_stream")
    log("finditer_stream: %d events" % len(evs))

    host = compile_pattern(pat, use_device=False)
    sc.DEVICE_THRESHOLD = 1
    pool = rand_corpus(12, b"abc x", 8)
    docs = [pool[i << 18:(i + 1) << 18] + (b"baaaaccb" if i % 3 else b"")
            for i in range(24)] + [b"", b"baaaaccb", b"x" * 2047]
    h = sc.prepare_many(docs)
    check(sc.count_many(docs, prepared=h) == [host.count(d) for d in docs],
          "count_many")
    device_tier(sc)
    check(sc.scan_many(docs, prepared=h) == [host.scan(d) for d in docs],
          "scan_many")
    fpat = rb"(\w+)@(\w+)"
    scf = compile_pattern(fpat, use_device=True)
    scf.DEVICE_THRESHOLD = 1
    hostf = compile_pattern(fpat, use_device=False)
    fdocs = [d[:1 << 16] + (b" ab%d@cd%d " % (i, i) if i % 2 else b"")
             for i, d in enumerate(docs[:8])]
    check(scf.find_many(fdocs) == [hostf.find(d) for d in fdocs],
          "find_many")
    device_tier(scf)
    log("count_many / scan_many / find_many over %d documents" % len(docs))

    words = [w.encode() for w in
             "epsilon theta lambda omicron upsilon gamma sigma kappa"
             .split()]
    ast, _ = parse_multi(words)
    os.environ["SREGEX_TIER_AB"] = "0"
    try:
        sc = Scanner(compile_regex(ast), use_device=True, ast=ast)
        host = Scanner(compile_regex(ast), use_device=False, ast=ast)
        base = rand_corpus(13, b"zxqwvu ", 8,
                           [(0.1, b" lambda "), (0.35, b" kappa "),
                            (0.6, b" sigma "), (0.85, b" theta ")])
        check(sc.count(base) == host.count(base), "fused count")
        tier = device_tier(sc)
        docs = [base[i << 20:(i << 20) + (1 << 20 | (i * 4097))]
                for i in range(6)]
        check(sc.count_many(docs) == [host.count(d) for d in docs],
              "fused count_many")
        device_tier(sc)
        idx = sc.make_index(docs[0])
        check(list(sc.finditer(docs[0], index=idx))
              == list(host.finditer(docs[0])), "fused finditer")
        log("fused core (%s): count, count_many, finditer" % tier)
    finally:
        os.environ.pop("SREGEX_TIER_AB", None)

    pat = rb"(foo|bar|baz|qux)=[0-9a-f]{2,8}"
    sc = compile_pattern(pat, use_device=True)
    data = rand_corpus(14, b"0123 456 789 -- ", 8)
    k, st = sc._native.count(data, 0)
    check(sc.count(data) == k + int(sc.dfa.match_eof[st]), "tier-ab")
    device_tier(sc)
    log("tier A/B: %r" % (getattr(sc, "tier_ab", None),))


def run_one_card(mb=MB, kernel="triton"):
    env = phase_env()
    with Phase("workloads"):
        w = build_workloads(mb)
    with Phase("kernels vs plain reference"):
        shapes = phase_kernels(w, kernel)
    with Phase("timing (kernel and plain, in turns)"):
        phase_timing(w, shapes, kernel)
    with Phase("main path"):
        phase_main(w)
    with Phase("other tiers"):
        phase_tiers()
    log("peak device bytes in use: %s" % peak_bytes())
    return env


def run_mesh(nchips, mb=MB):
    """The mesh paths on ``nchips`` devices, each against the same
    process's one-device result and the native oracle."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from sregex_tpu import parse_multi, compile_regex
    from sregex_tpu.stream import Scanner, compile_pattern
    from sregex_tpu.parallel import sharded_scan_bytes
    from sregex_tpu.ops.scan import dfa_device_tables
    from sregex_tpu import workloads as wl
    env = phase_env()
    check(env["count"] >= nchips, "need %d devices" % nchips)
    devs = jax.devices()[:nchips]
    mesh = Mesh(np.array(devs), ("data",))
    mesh1 = Mesh(np.array(devs[:1]), ("data",))
    with Phase("workloads"):
        w = build_workloads(mb)

    for name, expect in (("headline", "SpecTables"),
                         ("multi", "CoreTables")):
        d = w[name]
        with Phase("mesh %s" % name):
            sc1 = d["sc"]
            prog = sc1.program
            scm = Scanner(prog, use_device=True, ast=sc1.ast,
                          dfa=sc1.dfa, mesh=mesh)
            corpus = d["corpus"]
            for api, exp in (("count", d["count"]), ("scan", None)):
                t0 = time.perf_counter()
                r1 = getattr(sc1, api)(corpus)
                t1 = time.perf_counter()
                rm = getattr(scm, api)(corpus)
                t2 = time.perf_counter()
                device_tier(sc1, expect)
                device_tier(scm, expect)
                if exp is None:
                    exp = (r1[0], d["first"]) if r1 else None
                check(r1 == rm == exp, "%s %s: 1 device %r, %d devices "
                      "%r, native %r" % (name, api, r1, nchips, rm, exp))
                log("%s %s = %r on 1 and %d devices (%.2fs, %.2fs, "
                    "tier %s)" % (name, api, rm, nchips, t1 - t0,
                                  t2 - t1, expect))
            tables = dfa_device_tables(sc1.dfa)
            rs = {}
            for label, msh in (("1", mesh1), (str(nchips), mesh)):
                t0 = time.perf_counter()
                rs[label] = sharded_scan_bytes(tables, corpus, mesh=msh)
                log("sharded_scan %s on %s device(s): %r (%.2fs)"
                    % (name, label, rs[label], time.perf_counter() - t0))
            nf, nst = sc1._native.scan_first(corpus, 0)
            check(rs["1"] == rs[str(nchips)], "sharded_scan 1 vs mesh")
            check(rs["1"][1] == nf, "sharded_scan vs native %r" % nf)
            if name == "headline":
                L = len(corpus) // 16
                docs = [corpus[j * L:(j + 1) * L] for j in range(16)]
                c1 = sc1.count_many(docs)
                cm = scm.count_many(docs)
                nat = []
                for doc in docs:
                    k, st = sc1._native.count(doc, 0)
                    nat.append(k + int(sc1.dfa.match_eof[st]))
                check(c1 == cm == nat, "batch count_many %r %r %r"
                      % (c1, cm, nat))
                device_tier(scm)
                log("batch count_many over 16 documents on %d devices: "
                    "%r" % (nchips, cm))
    log("peak device bytes in use (device 0): %s" % peak_bytes())
    return env


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the mesh paths on four devices")
    args = ap.parse_args(argv)
    if args.chips == 1:
        env = run_one_card()
    else:
        env = run_mesh(args.chips)
    print(json.dumps({"ok": True, "device": {
        "platform": env["platform"], "kind": env["kind"],
        "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
