"""Fused two-phase count (pallas_core.core_count_fused): core kernel
+ on-device escape compaction + full-machine redo + merged validation
in one jit, vs the native oracle (the plain walk on the CPU mesh)."""

import random

import numpy as np
import pytest

from sregex_tpu import parse, parse_multi, compile_regex
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops.pallas_core import (CoreTables, core_count_fused,
                                        core_count_bytes)


def _multi_machine(nwords=14, wordlen=4, seed=2):
    """Keyword-set machine whose static tier is wide on the CPU mesh
    and whose core stays wide too (the bench-multi shape, scaled
    down for the CPU tests)."""
    rng = random.Random(seed)
    words = list({("".join(rng.choice("abcdefghijklmn")
                           for _ in range(wordlen))).encode()
                  for _ in range(nwords)})
    ast, _ = parse_multi(words)
    dfa = build_dfa(compile_regex(ast))
    return dfa, words


def _corpus(words, n, seed, plant_every=8192):
    rng = random.Random(seed)
    filler = [("".join(rng.choice("nopqrstuv") for _ in range(5)))
              .encode() for _ in range(12)]
    piece = b" ".join(rng.choice(filler) for _ in range(64)) + b" "
    body = piece * (n // len(piece) + 1)
    out = bytearray(body[:n])
    for pos in range(plant_every, n - 16, plant_every):
        w = words[rng.randrange(len(words))]
        out[pos:pos + len(w) + 2] = b" " + w + b" "
    return bytes(out)


@pytest.mark.parametrize("n", [400_000, 65_537, 4096 * 2048 // 8])
def test_fused_count_exact(n):
    dfa, words = _multi_machine()
    from sregex_tpu.ops.pallas_scan import (SpecTables, SpecTablesWide)
    try:
        full = SpecTables(dfa)
    except ValueError:
        full = SpecTablesWide(dfa)
    data = _corpus(words, n, seed=n & 0xFF)
    ct = CoreTables(dfa, data[:64 << 10], require_fast=False)
    native = NativeDfa(dfa)
    exp = native.count(data, 0)
    r = core_count_fused(ct, full, data, chunk_len=512)
    assert r is not None, "fused path declined"
    st, got = r
    assert (got, st) == (exp[0], exp[1]), (got, exp)
    # escapes happened (the plants leave the core) yet no host repair
    # unless the chain broke
    nat, C = ct.last_repair
    assert C > 0


def test_fused_count_matches_legacy_and_repair_stats():
    dfa, words = _multi_machine(nwords=10, wordlen=5, seed=5)
    from sregex_tpu.ops.pallas_scan import (SpecTables, SpecTablesWide)
    try:
        full = SpecTables(dfa)
    except ValueError:
        full = SpecTablesWide(dfa)
    data = _corpus(words, 600_000, seed=9, plant_every=4096)
    ct = CoreTables(dfa, data[:64 << 10], require_fast=False)
    native = NativeDfa(dfa)
    exp = native.count(data, 0)
    st_f, got_f = core_count_fused(ct, full, data, chunk_len=512)
    rep_f = ct.last_repair
    st_l, got_l = core_count_bytes(ct, data, chunk_len=512)
    assert (got_f, st_f) == (got_l, st_l) == (exp[0], exp[1])
    # the fused path must repair far less on host than the legacy
    # fold (device redo absorbs the escapes)
    nat_f, _ = rep_f
    nat_l, _ = ct.last_repair
    assert nat_f <= nat_l


def test_fused_overflow_falls_back_to_host_fold(monkeypatch):
    """More escapes than the device cap: the legacy host fold serves,
    still exact."""
    monkeypatch.setenv("SREGEX_FUSED_CAP", "4096")
    import importlib
    import sregex_tpu.ops.pallas_core as pc
    monkeypatch.setattr(pc, "FUSED_CAP", 4096)
    dfa, words = _multi_machine(nwords=8, wordlen=4, seed=11)
    from sregex_tpu.ops.pallas_scan import (SpecTables, SpecTablesWide)
    try:
        full = SpecTables(dfa)
    except ValueError:
        full = SpecTablesWide(dfa)
    # plant a keyword into EVERY chunk: every chunk escapes
    data = bytearray(_corpus(words, 300_000, seed=3,
                             plant_every=1 << 20))
    for pos in range(64, len(data) - 16, 256):
        w = words[pos % len(words)]
        data[pos:pos + len(w) + 2] = b" " + w + b" "
    data = bytes(data)
    ct = CoreTables(dfa, data[:8 << 10], require_fast=False,
                    max_escape_frac=0.5)
    native = NativeDfa(dfa)
    exp = native.count(data, 0)
    r = pc.core_count_fused(ct, full, data, chunk_len=512)
    assert r is not None
    st, got = r
    assert (got, st) == (exp[0], exp[1])


def test_fused_chunk0_escape_exact():
    """Regression (round-4 advisor, HIGH): a chunk-0 escape must keep
    its phase-2 redo.  The merge scatter used to pad unused selection
    slots with index 0; duplicate-index scatter order is undefined in
    JAX, and the padding's stale pre-scatter write clobbered chunk 0's
    redo (observed 494 vs oracle 49).  Padding now rides out-of-range
    indices with mode="drop"."""
    dfa, words = _multi_machine()
    from sregex_tpu.ops.pallas_scan import (SpecTables, SpecTablesWide)
    from sregex_tpu.ops.pallas_core import core_scan_fused
    try:
        full = SpecTables(dfa)
    except ValueError:
        full = SpecTablesWide(dfa)
    native = NativeDfa(dfa)
    # keywords only inside chunk 0 (chunk_len=512): n_esc < CAP so
    # padding slots exist in the phase-2 selection
    data = bytearray(_corpus(words, 200_000, seed=7,
                             plant_every=1 << 30))
    w = words[0]
    data[40:40 + len(w) + 2] = b" " + w + b" "
    data[200:200 + len(w) + 2] = b" " + w + b" "
    data = bytes(data)
    # sample the core from a keyword-free region so chunk 0 escapes
    # (no_pair: the keyword-free sample would qualify the pair tier,
    # which the fused path declines)
    ct = CoreTables(dfa, data[8 << 10:72 << 10], require_fast=False,
                    no_pair=True)
    exp = native.count(data, 0)
    assert exp[0] >= 2, "setup: chunk-0 plants must match"
    r = core_count_fused(ct, full, data, chunk_len=512)
    assert r is not None
    st, got = r
    assert (got, st) == (exp[0], exp[1])
    # first-match variant: the fire is inside the redone chunk 0
    exp_f, exp_st = native.scan_first(data, 0)
    r = core_scan_fused(ct, full, data, chunk_len=512)
    assert r is not None
    st, f = r
    assert (f, st) == (exp_f, exp_st)


def test_fused_small_and_tail_edges():
    dfa, words = _multi_machine(nwords=6, wordlen=4, seed=21)
    from sregex_tpu.ops.pallas_scan import (SpecTables, SpecTablesWide)
    try:
        full = SpecTables(dfa)
    except ValueError:
        full = SpecTablesWide(dfa)
    native = NativeDfa(dfa)
    sample = _corpus(words, 32 << 10, seed=1)
    ct = CoreTables(dfa, sample, require_fast=False)
    for n in [0, 1, 511, 512, 513, 5000]:
        data = _corpus(words, n, seed=n + 1) if n else b""
        r = core_count_fused(ct, full, data, chunk_len=512)
        assert r is not None
        st, got = r
        exp = native.count(data, 0)
        assert (got, st) == (exp[0], exp[1]), n


def test_scanner_count_uses_fused_tier():
    """Scanner.count routes long-chain wide machines through the
    fused two-phase path and stays exact (CPU mesh; SREGEX_TIER_AB
    is pinned off by conftest, so the fused tier serves directly)."""
    from sregex_tpu import parse_multi
    from sregex_tpu.stream import Scanner
    dfa, words = _multi_machine()
    rng = random.Random(77)
    ast, _ = parse_multi(words)
    prog = compile_regex(ast)
    sc = Scanner(prog, use_device=True, ast=ast)
    sc.DEVICE_THRESHOLD = 1 << 14
    from sregex_tpu.ops.pallas_scan import SpecTablesWide
    if not (isinstance(sc._spec, SpecTablesWide)
            and sc._spec.rows > 4):
        pytest.skip("machine shape drifted below the fused band")
    data = _corpus(words, 500_000, seed=31, plant_every=8192)
    exp_c, exp_st = sc._native.count(data, 0)
    exp = exp_c + int(sc.dfa.match_eof[exp_st])
    got = sc.count(data)
    assert got == exp
    assert sc._fusedct not in (None, False), "fused tier not engaged"
    st = sc.stats()
    assert st.tier == "CoreTables" and st.chunks > 0
    # prepared-corpus path reuses both uploads
    prep = sc.prepare(data)
    assert sc.count(data, prepared=prep) == exp
    assert sc.count(data, prepared=prep) == exp


def test_fused_scan_first_match_exact():
    """core_scan_fused: contract of spec_scan_bytes (state AT the
    boundary; boundaries 0..n-1), with the first firing chunk pinned
    from its validated entry."""
    dfa, words = _multi_machine()
    from sregex_tpu.ops.pallas_scan import (SpecTables, SpecTablesWide)
    from sregex_tpu.ops.pallas_core import core_scan_fused
    try:
        full = SpecTables(dfa)
    except ValueError:
        full = SpecTablesWide(dfa)
    native = NativeDfa(dfa)
    sample = _corpus(words, 64 << 10, seed=1)
    ct = CoreTables(dfa, sample, require_fast=False)
    for n, plant_every in [(400_000, 8192), (300_000, 1 << 30),
                           (2049, 700), (0, 1)]:
        data = _corpus(words, n, seed=n % 97,
                       plant_every=plant_every) if n else b""
        r = core_scan_fused(ct, full, data, chunk_len=512)
        assert r is not None
        st, f = r
        exp_f, exp_st = native.scan_first(data, 0)
        assert (f, st) == (exp_f, exp_st), (n, f, exp_f)


def test_scanner_scan_uses_fused_tier():
    from sregex_tpu import parse_multi
    from sregex_tpu.stream import Scanner
    dfa, words = _multi_machine()
    ast, _ = parse_multi(words)
    prog = compile_regex(ast)
    sc = Scanner(prog, use_device=True, ast=ast)
    sc.DEVICE_THRESHOLD = 1 << 14
    from sregex_tpu.ops.pallas_scan import SpecTablesWide
    if not (isinstance(sc._spec, SpecTablesWide)
            and sc._spec.rows > 4):
        pytest.skip("machine shape drifted below the fused band")
    data = _corpus(words, 400_000, seed=41, plant_every=16384)
    exp = sc._native.scan_first(data, 0)
    got = sc.scan(data)
    if exp[0] >= 0:
        assert got is not None and got[1] == exp[0]
    assert sc._fusedct not in (None, False)


def test_sregex_core_env_disables_fused(monkeypatch):
    """SREGEX_CORE=0 must keep ALL core tiers out, including the
    fused two-phase path (the hardware smoke tiers rely on it)."""
    monkeypatch.setenv("SREGEX_CORE", "0")
    from sregex_tpu import parse_multi
    from sregex_tpu.stream import Scanner
    dfa, words = _multi_machine()
    ast, _ = parse_multi(words)
    prog = compile_regex(ast)
    sc = Scanner(prog, use_device=True, ast=ast)
    sc.DEVICE_THRESHOLD = 1 << 14
    data = _corpus(words, 100_000, seed=51)
    exp_c, exp_st = sc._native.count(data, 0)
    assert sc.count(data) == exp_c + int(sc.dfa.match_eof[exp_st])
    assert sc._fusedct is False


def test_fused_with_big_full_tables(monkeypatch):
    """Machines past the wide cap redo escapes on the BIG kernel in
    phase 2 (SREGEX_AFFINE=0 forces the chain monster onto the big
    tier, its pre-round-4 home)."""
    monkeypatch.setenv("SREGEX_AFFINE", "0")
    from sregex_tpu.ops.pallas_big import SpecTablesBig
    from sregex_tpu.ops.pallas_core import core_scan_fused
    ast, _ = parse(rb"(?:ab?c){60,140}z")
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    full = SpecTablesBig(dfa)
    native = NativeDfa(dfa)
    rng = random.Random(23)
    # skewed corpus (mostly fillers, occasional chain excursions):
    # the hot set is tiny, escapes redo on the big kernel
    data = bytearray()
    while len(data) < 400_000:
        data += bytes(rng.choice(b"xyzw .") for _ in range(
            rng.randrange(200, 900)))
        data += b"abc" * rng.randrange(1, 30)
    data = bytes(data[:400_000])
    ct = CoreTables(dfa, data[:64 << 10], require_fast=False,
                    no_pair=True)
    exp_c, exp_st = native.count(data, 0)
    r = core_count_fused(ct, full, data, chunk_len=512)
    assert r is not None, "fused declined for big full tables"
    st, got = r
    assert (got, st) == (exp_c, exp_st)
    exp_f, exp_fst = native.scan_first(data, 0)
    r = core_scan_fused(ct, full, data, chunk_len=512)
    assert r is not None
    st, f = r
    assert (f, st) == (exp_f, exp_fst)


def test_scanner_fused_over_big_tier(monkeypatch):
    monkeypatch.setenv("SREGEX_AFFINE", "0")
    from sregex_tpu import parse as _parse
    from sregex_tpu.stream import Scanner
    from sregex_tpu.ops.pallas_big import SpecTablesBig
    # 11,020 entries: past even the CPU wide cap -> big tier
    ast, _ = _parse(rb"(?:a[bc]|de*f|g[hi]j){220,490}z")
    prog = compile_regex(ast)
    sc = Scanner(prog, use_device=True, ast=ast)
    if not isinstance(sc._spec, SpecTablesBig):
        pytest.skip("machine no longer lands on the big tier")
    sc.DEVICE_THRESHOLD = 1 << 14
    rng = random.Random(29)
    data = bytes(rng.choice(b"abcdefghij .") for _ in range(300_000))
    exp_c, exp_st = sc._native.count(data, 0)
    exp = exp_c + int(sc.dfa.match_eof[exp_st])
    assert sc.count(data) == exp
    # the fused tier engaged over the big static tier (or declined
    # legitimately if no core covers this corpus — assert it at
    # least TRIED and stayed exact)
    assert sc._fusedct is not None


def test_fused_phase2_warmup_ladder_escalation():
    """VERDICT r4 #2: corpora whose escape regions exceed the FULL
    machine's default 32-byte warmup used to repair those chunks on
    host forever (the phase-2 redo could never certify).  The fused
    path now escalates the warmup ladder on sustained chain-miss
    repairs, and the escalated tables thread straight into the
    phase-2 tables — after which the same corpus scans with (near)
    zero host repairs.  Matches the corpus-independence of the
    reference JIT (sre_vm_thompson_x64.dasc:738-889)."""
    import os
    from sregex_tpu import parse
    from sregex_tpu.stream import Scanner

    os.environ["SREGEX_AFFINE"] = "0"   # pin the fused path (the
    try:                                # affine tier would grab this)
        ast, _ = parse(b"a{200,400}b")
        sc = Scanner(compile_regex(ast), use_device=True, ast=ast)
        from sregex_tpu.ops.pallas_scan import SpecTablesWide
        assert isinstance(sc._spec, SpecTablesWide) and \
            sc._spec.rows > 4, "machine left the fused band"
        assert sc._spec.warmup == 32
        sc.DEVICE_THRESHOLD = 1 << 12

        rng = random.Random(7)
        # benign head (short runs: every window converges) feeds the
        # core sample; long excursions (250..450-byte 'a' runs) only
        # appear PAST the sample, so they escape the core and the
        # phase-2 redo must certify mid-run — impossible at W=32
        head = bytearray()
        while len(head) < sc.CORE_SAMPLE:
            head += b"a" * rng.randrange(5, 40) + b" "
        body = bytearray(bytes(head[:sc.CORE_SAMPLE]))
        while len(body) < 500_000:
            body += b"a" * rng.randrange(250, 450) \
                + rng.choice([b"b", b" "]) \
                + b"a" * rng.randrange(5, 40) + b" "
        data = bytes(body[:500_000])

        native = NativeDfa(sc.dfa)
        exp_c, exp_st = native.count(data, 0)
        exp = exp_c + int(sc.dfa.match_eof[exp_st])

        reps = []
        for _ in range(6):
            assert sc.count(data) == exp      # exact at every rung
            st = sc.stats()
            assert st.tier == "CoreTables", st
            reps.append((sc._spec.warmup, st.repaired, st.chunks))
            if sc._spec.warmup >= 512 and st.repaired <= 1:
                break
        # the ladder engaged (32 -> ... -> >= 512) and the final scan
        # kept the fused tier's zero-host-repair property
        assert sc._fusedct not in (None, False), reps
        assert reps[0][1] > reps[0][2] * 0.25, reps  # hostile at W=32
        assert sc._spec.warmup >= 512, reps
        assert reps[-1][1] <= 1, reps
    finally:
        os.environ.pop("SREGEX_AFFINE", None)


# ---------------------------------------------------------------------
# Fused two-phase on a device mesh (VERDICT r4 #3): the whole
# dispatch shard_maps over the chunk-block dim — phase-1 planes,
# escape compaction, the phase-2 window gather and the merge are
# shard-local; the validation chain stitches shards with one ppermute
# of each shard's last exit; the per-shard summaries fold back into
# the single-chip contract on host.
# ---------------------------------------------------------------------

import jax as _jax
import pytest as _pytest


@_pytest.fixture(scope="module")
def mesh():
    if len(_jax.devices()) < 2:
        _pytest.skip("needs multi-device (virtual) platform")
    from sregex_tpu.parallel import make_mesh
    return make_mesh()


def _fused_setup(n=400_000, plant_every=8192, chunk0=True, seed=2):
    dfa, words = _multi_machine(seed=seed)
    from sregex_tpu.ops.pallas_scan import SpecTables, SpecTablesWide
    try:
        full = SpecTables(dfa)
    except ValueError:
        full = SpecTablesWide(dfa)
    data = bytearray(_corpus(words, n, seed=seed,
                             plant_every=plant_every))
    if chunk0:
        w = words[0]
        data[10:10 + len(w) + 2] = b" " + w + b" "
    data = bytes(data)
    ct = CoreTables(dfa, data[:64 << 10], require_fast=False,
                    no_pair=True)
    return dfa, full, ct, data


def test_fused_mesh_count_and_scan_exact(mesh):
    """Counts/first-match over the mesh must equal the native oracle
    — including a chunk-0 escape (shard-0 stitch takes the caller's
    entry) and plants that straddle shard boundaries."""
    dfa, full, ct, data = _fused_setup()
    native = NativeDfa(dfa)
    exp_c, exp_st = native.count(data, 0)
    r = core_count_fused(ct, full, data, chunk_len=512, mesh=mesh)
    assert r is not None, "fused mesh path declined"
    st, got = r
    assert (got, st) == (exp_c, exp_st)
    # escapes happened and were redone on device, shard-locally
    assert ct.last_repair == (0, ct.last_repair[1])
    from sregex_tpu.ops.pallas_core import core_scan_fused
    exp_f, exp_s = native.scan_first(data, 0)
    stf, first = core_scan_fused(ct, full, data, chunk_len=512,
                                 mesh=mesh)
    assert (first, stf) == (exp_f, exp_s)


def test_fused_mesh_matches_single_chip(mesh):
    """Same corpus, mesh vs single-chip fused: identical results."""
    dfa, full, ct, data = _fused_setup(n=300_000, plant_every=4096,
                                       seed=5)
    st1, got1 = core_count_fused(ct, full, data, chunk_len=512)
    st2, got2 = core_count_fused(ct, full, data, chunk_len=512,
                                 mesh=mesh)
    assert (st1, got1) == (st2, got2)


def test_fused_mesh_overflow_falls_back_exact(mesh, monkeypatch):
    """Per-shard escape overflow on the mesh: the legacy host fold
    over the global core planes still serves, exact."""
    import sregex_tpu.ops.pallas_core as pc
    monkeypatch.setattr(pc, "FUSED_CAP", 4096)
    dfa, words = _multi_machine(nwords=8, wordlen=4, seed=11)
    from sregex_tpu.ops.pallas_scan import SpecTables, SpecTablesWide
    try:
        full = SpecTables(dfa)
    except ValueError:
        full = SpecTablesWide(dfa)
    data = bytearray(_corpus(words, 300_000, seed=3,
                             plant_every=1 << 20))
    for pos in range(64, len(data) - 16, 256):
        w = words[pos % len(words)]
        data[pos:pos + len(w) + 2] = b" " + w + b" "
    data = bytes(data)
    ct = CoreTables(dfa, data[:8 << 10], require_fast=False,
                    max_escape_frac=0.5)
    native = NativeDfa(dfa)
    exp_c, exp_st = native.count(data, 0)
    r = pc.core_count_fused(ct, full, data, chunk_len=512, mesh=mesh)
    assert r is not None
    st, got = r
    assert (got, st) == (exp_c, exp_st)


def test_scanner_mesh_serves_fused(mesh):
    """A Scanner built with mesh= must serve the fused tier (the
    round-4 decline at the fused-band gate is gone) with exact
    results."""
    import random as _r
    from sregex_tpu import parse_multi
    from sregex_tpu.stream import Scanner
    rng = _r.Random(2)
    words = list({("".join(rng.choice("abcdefghijklmn")
                           for _ in range(4))).encode()
                  for _ in range(14)})
    ast, _ = parse_multi(words)
    sc = Scanner(compile_regex(ast), use_device=True, ast=ast,
                 mesh=mesh)
    sc.DEVICE_THRESHOLD = 1 << 12
    data = _corpus(words, 400_000, seed=7)
    native = NativeDfa(sc.dfa)
    exp_c, exp_st = native.count(data, 0)
    exp = exp_c + int(sc.dfa.match_eof[exp_st])
    assert sc.count(data) == exp
    assert sc._fusedct not in (None, False), "fused declined on mesh"
    assert sc.stats().tier == "CoreTables"


def test_fused_reverse_index_finditer_exact():
    """Round 5 (VERDICT r4 #7): the finditer start locator's reverse
    chunk map rides the fused two-phase dispatch when the reverse
    machine is fused-band — escapes redo on device (zero host
    repairs here) and finditer stays byte-exact vs the host engine,
    including a match planted in (reverse) chunk 0."""
    import random as _r
    from sregex_tpu import parse_multi
    from sregex_tpu.stream import Scanner
    rng = _r.Random(2)
    words = list({("".join(rng.choice("abcdefghijklmn")
                           for _ in range(4))).encode()
                  for _ in range(14)})
    ast, _ = parse_multi(words)
    sc = Scanner(compile_regex(ast), use_device=True, ast=ast)
    sc.DEVICE_THRESHOLD = 1 << 12
    host = Scanner(compile_regex(ast), use_device=False, ast=ast)
    filler = [("".join(rng.choice("nopqrstuv") for _ in range(5)))
              .encode() for _ in range(12)]
    piece = b" ".join(rng.choice(filler) for _ in range(64)) + b" "
    n = 200_000
    out = bytearray((piece * (n // len(piece) + 1))[:n])
    for pos in range(4096, n - 16, 4096):
        w = words[rng.randrange(len(words))]
        out[pos:pos + len(w) + 2] = b" " + w + b" "
    w = words[1]
    out[3:3 + len(w) + 2] = b" " + w + b" "       # near offset 0
    out[n - 10:n - 10 + len(w)] = w               # near EOF (rev c0)
    data = bytes(out)
    idx = sc.make_index(data)
    assert sc._rev_fusedct not in (None, False), \
        "fused reverse tier not engaged"
    got = list(sc.finditer(data, index=idx))
    exp = list(host.finditer(data))
    assert got == exp
    # the fused chunk map absorbed every escape on device
    assert sc._rev_fusedct.last_repair[0] == 0, \
        sc._rev_fusedct.last_repair


def test_precompile_warms_fused_traces():
    """Scanner.precompile(nbytes, sample) pushes a zero-filled device
    stand-in through the exact prep + fused dispatch flow — the
    subsequent REAL count reuses every trace and stays exact.  bench.py overlaps
    this with the native oracle count (VERDICT r4 #8)."""
    import random as _r
    import time as _t
    from sregex_tpu import parse_multi
    from sregex_tpu.stream import Scanner
    rng = _r.Random(2)
    words = list({("".join(rng.choice("abcdefghijklmn")
                           for _ in range(4))).encode()
                  for _ in range(14)})
    ast, _ = parse_multi(words)
    sc = Scanner(compile_regex(ast), use_device=True, ast=ast)
    sc.DEVICE_THRESHOLD = 1 << 12
    data = _corpus(words, 300_000, seed=4)
    t_pre = sc.precompile(len(data), sample=data[:sc.CORE_SAMPLE])
    assert t_pre > 0
    assert sc._fusedct not in (None, False)
    exp_c, exp_st = sc._native.count(data, 0)
    exp = exp_c + int(sc.dfa.match_eof[exp_st])
    t0 = _t.perf_counter()
    assert sc.count(data) == exp
    warm = _t.perf_counter() - t0
    assert sc.stats().tier == "CoreTables"
    # the warm count must be far under the precompile cost (trace
    # reuse; generous 2x bound against CPU-mesh noise)
    assert warm < max(2.0, t_pre / 2), (warm, t_pre)
