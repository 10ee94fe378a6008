"""Speculative walk under shard_map on the virtual 8-device
CPU mesh (the fast multi-device path): per-chunk planes come
back in global chunk order, so the swarm==entries validation chain
stitches shards exactly — including assertions (\\b, ^) straddling
shard boundaries, which ride the warmup context like any chunk
boundary."""

import random

import numpy as np
import jax
import pytest

from sregex_tpu import parse, compile_regex
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops.pallas_scan import (SpecTables, SpecTablesWide,
                                        spec_scan_bytes,
                                        spec_count_bytes)
from sregex_tpu.ops.pallas_big import SpecTablesBig
from sregex_tpu.parallel import make_mesh


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multi-device (virtual) platform")
    return make_mesh()


def _tiered_tables(pattern):
    ast, _ = parse(pattern)
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    for cls in (SpecTables, SpecTablesWide, SpecTablesBig):
        try:
            return dfa, cls(dfa), NativeDfa(dfa)
        except ValueError:
            continue
    raise AssertionError("no tier accepted %r" % pattern)


CASES = [
    # narrow tier
    ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", b"abc", b"abccc aaabbccb"),
    # assertions that straddle shard boundaries
    (r"\bword\b", b"word abc ", b" word "),
    ("^line", b"text\nline ", b"\nline"),
    # wide tier
    ("(abc|def|ghi|jkl)(mno|pqr)", b"abcdefghijklmnopqr",
     b"abcmno"),
    # big tier (S*ncls > 1024)
    ("a{20,45}b", b"aab x", b"x" + b"a" * 30 + b"b"),
]


@pytest.mark.parametrize("pattern,alphabet,planted", CASES)
def test_sharded_spec_matches_native(pattern, alphabet, planted, mesh):
    dfa, tables, native = _tiered_tables(pattern)
    rng = random.Random(hash(pattern) & 0xFFFF)
    for trial in range(3):
        n = rng.choice([500, 3000, 9000])
        data = bytes(rng.choice(alphabet) for _ in range(n))
        if trial != 1:
            # plant straddling a 256-byte chunk boundary: the planted
            # text crosses chunk AND shard edges
            at = 256 * rng.randrange(1, max(2, n // 256)) \
                - len(planted) // 2
            data = data[:at] + planted + data[at:]
        exp_first, exp_state = native.scan_first(data, 0)
        got_state, got_first = spec_scan_bytes(tables, data,
                                               chunk_len=256,
                                               mesh=mesh)
        assert got_first == exp_first, \
            "%r: first %r != %r" % (pattern, got_first, exp_first)
        assert got_state == exp_state


def test_sharded_spec_count(mesh):
    dfa, tables, native = _tiered_tables("ab")
    rng = random.Random(9)
    data = bytes(rng.choice(b"aab b") for _ in range(20000))
    exp, exp_st = native.count(data, 0)
    st, got = spec_count_bytes(tables, data, chunk_len=256, mesh=mesh)
    assert (st, got) == (exp_st, exp)


def test_sharded_spec_multi_regex_ids(mesh):
    from sregex_tpu.parser import parse_multi
    ast, _ = parse_multi([b"abcd", b"bc", b"zz"])
    dfa = build_dfa(compile_regex(ast))
    for cls in (SpecTables, SpecTablesWide, SpecTablesBig):
        try:
            tables = cls(dfa)
            break
        except ValueError:
            continue
    native = NativeDfa(dfa)
    rng = random.Random(2)
    data = bytes(rng.choice(b"abcdz x") for _ in range(5000))
    exp_first, _, exp_rid = None, None, None
    f, rid, st = native.scan_first_id(data, 0)
    got_state, got_first = spec_scan_bytes(tables, data,
                                           chunk_len=256, mesh=mesh)
    assert got_first == f
    if f >= 0:
        assert dfa.id_at(got_state, data[got_first]) == rid


def test_sharded_core_tier_matches_native(mesh):
    """The adaptive hot-core tier rides the mesh exactly like the
    static tiers (per-chunk planes come back in global chunk order;
    the host fold is mesh-agnostic).  Big automaton + skewed corpus
    + a planted match straddling shard-interior chunks."""
    from sregex_tpu.ops.pallas_core import (CoreTables,
                                            core_scan_bytes,
                                            core_count_bytes)
    ast, _ = parse("a{60,120}b")
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    native = NativeDfa(dfa)
    rng = random.Random(23)
    sample = bytes(rng.choice(b"ab xx") for _ in range(20000))
    ct = CoreTables(dfa, sample)
    data = bytes(rng.choice(b"ab xx") for _ in range(20000))
    data = data[:9000] + b"c" + b"a" * 90 + b"b" + data[9000:]
    exp_first, exp_state = native.scan_first(data, 0)
    st, first = core_scan_bytes(ct, data, chunk_len=256, mesh=mesh)
    assert (first, st) == (exp_first, exp_state)
    exp_cnt, exp_st = native.count(data, 0)
    st, cnt = core_count_bytes(ct, data, chunk_len=256, mesh=mesh)
    assert (cnt, st) == (exp_cnt, exp_st)


def test_scanner_mesh_kwarg(mesh):
    """Scanner(mesh=...) shards its device scans across the mesh; the
    results stay byte-exact with the single-chip path."""
    from sregex_tpu.stream import compile_pattern
    import random as _r
    rng = _r.Random(5)
    sc = compile_pattern("(?:a|b)aa(?:aa|bb)cc(?:a|b)",
                         use_device=True, mesh=mesh)
    sc.DEVICE_THRESHOLD = 1 << 12
    data = bytes(rng.choice(b"abccc x") for _ in range(30000))
    data = data[:20000] + b"xaaabbccb" + data[20000:]
    nat = NativeDfa(sc.dfa)
    exp_c, exp_st = nat.count(data, 0)
    assert sc.count(data) == exp_c + int(sc.dfa.match_eof[exp_st])
    exp_f, exp_s = nat.scan_first(data, 0)
    rid, end = sc.scan(data)
    assert end == exp_f and rid == sc.dfa.id_at(exp_s, data[exp_f])
    # core-tier pattern over the mesh
    sc2 = compile_pattern("a{60,120}b", use_device=True, mesh=mesh)
    sc2.DEVICE_THRESHOLD = 1 << 12
    d2 = bytes(rng.choice(b"ab xx") for _ in range(20000))
    d2 = d2[:9000] + b"c" + b"a" * 90 + b"b" + d2[9000:]
    nat2 = NativeDfa(sc2.dfa)
    exp_c, exp_st = nat2.count(d2, 0)
    assert sc2.count(d2) == exp_c + int(sc2.dfa.match_eof[exp_st])
