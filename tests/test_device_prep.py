"""Device-side preprocessing (ops/prep.py) must be BIT-IDENTICAL to
the host prep — the scan kernels cannot tell which path packed their
input."""

import os
import random

import numpy as np
import pytest

from sregex_tpu import parse, compile_regex
from sregex_tpu.dfa import build_dfa
from sregex_tpu.ops.pallas_scan import (SpecTables, SpecTablesWide,
                                        _prepare, spec_scan_bytes)
from sregex_tpu.ops.pallas_big import SpecTablesBig
from sregex_tpu.ops.prep import prepare_on_device, _class_runs

PATTERNS = [
    ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", SpecTables),          # bits=4
    (r"\bw\d+\b", SpecTables),                            # word/nl ctx
    ("(x|y|z[QW]){1,5}(longish|loquatious)", SpecTablesBig),  # bits=8
]


def test_class_runs_roundtrip():
    ast, _ = parse("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
    dfa = build_dfa(compile_regex(ast))
    starts, deltas = _class_runs(dfa.class_map)
    got = np.zeros(256, dtype=np.int32) + deltas[0]
    for r in range(1, len(starts)):
        got[starts[r]:] += deltas[r]
    assert np.array_equal(got, dfa.class_map.astype(np.int32))


@pytest.mark.parametrize("pattern,cls", PATTERNS)
def test_device_prep_bit_identical(pattern, cls):
    ast, _ = parse(pattern)
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    tables = cls(dfa)
    rng = random.Random(hash(pattern) & 0xFFFF)
    for n in (1, 255, 4096, 70000):
        data = bytes(rng.randrange(256) for _ in range(n))
        host = _prepare(tables, data, 256)
        dev = prepare_on_device(tables, data, 256)
        assert host[1:] == dev[1:], (host[1:], dev[1:])
        assert np.array_equal(np.asarray(host[0]), np.asarray(dev[0]))


def test_device_prep_b_multiple():
    ast, _ = parse("abc")
    dfa = build_dfa(compile_regex(ast))
    tables = SpecTables(dfa)
    data = bytes(100000)
    host = _prepare(tables, data, 256, b_multiple=8)
    dev = prepare_on_device(tables, data, 256, b_multiple=8)
    assert host[4] % 8 == 0 and host[1:] == dev[1:]
    assert np.array_equal(np.asarray(host[0]), np.asarray(dev[0]))


def test_scan_via_device_prep_matches_native():
    from sregex_tpu.native import NativeDfa
    os.environ["SREGEX_DEVICE_PREP"] = "1"
    try:
        ast, _ = parse("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
        dfa = build_dfa(compile_regex(ast))
        tables = SpecTables(dfa)
        native = NativeDfa(dfa)
        rng = random.Random(4)
        data = bytes(rng.choice(b"abc") for _ in range(30000))
        exp_first, exp_state = native.scan_first(data, 0)
        got_state, got_first = spec_scan_bytes(tables, data,
                                               chunk_len=256)
        assert (got_first, got_state) == (exp_first, exp_state)
    finally:
        del os.environ["SREGEX_DEVICE_PREP"]


def test_device_prep_pair_bit_identical():
    from sregex_tpu.ops.pallas_pair import SpecTablesPair
    # 4-bit pair packing (ncls^2 <= 16) and 8-bit (> 16)
    cases = [("abc", 4), (r"a[bc]d?e", 8)]
    for pattern, want_bits in cases:
        ast, _ = parse(pattern)
        dfa = build_dfa(compile_regex(ast))
        tables = SpecTablesPair(dfa)
        assert tables.bits == want_bits, (pattern, tables.bits)
        rng = random.Random(hash(pattern) & 0xFFFF)
        for n in (1, 255, 4096, 70001):
            data = bytes(rng.randrange(256) for _ in range(n))
            host = _prepare(tables, data, 256)
            dev = prepare_on_device(tables, data, 256)
            assert host[1:] == dev[1:], (pattern, n)
            assert np.array_equal(np.asarray(host[0]),
                                  np.asarray(dev[0])), (pattern, n)


def test_device_prep_prev_tail_bit_identical():
    """Real warmup bytes for chunk 0 (the pipelined streaming scan's
    prev_tail_cls) must pack bit-identically on both prep paths, for
    byte and pair units."""
    from sregex_tpu.ops.pallas_pair import SpecTablesPair
    for pattern, cls in [("(?:a|b)aa(?:aa|bb)cc(?:a|b)", SpecTables),
                         ("(?:a|b)aa(?:aa|bb)cc(?:a|b)",
                          SpecTablesPair),
                         (r"\bw\d+\b", SpecTables)]:
        ast, _ = parse(pattern)
        dfa = build_dfa(compile_regex(ast))
        tables = cls(dfa)
        rng = random.Random(len(pattern))
        W = tables.warmup
        cm = tables.class_map.tobytes()
        # tail bytes from the patterns' own alphabets so at least one
        # maps to a nonzero class (random 0..255 bytes almost always
        # land in the catch-all class, making the pad-vs-tail sanity
        # check below vacuous)
        tail_raw = bytes(rng.choice(b"ab1w cx") for _ in range(W))
        tail_cls = np.frombuffer(tail_raw.translate(cm), np.uint8)
        differed = False
        for n in (1, 255, 4096):
            data = bytes(rng.randrange(256) for _ in range(n))
            host = _prepare(tables, data, 256,
                            prev_tail_cls=tail_cls)
            dev = prepare_on_device(tables, data, 256,
                                    prev_tail_cls=tail_cls)
            assert host[1:] == dev[1:], (pattern, cls.__name__, n)
            assert np.array_equal(np.asarray(host[0]),
                                  np.asarray(dev[0])), \
                (pattern, cls.__name__, n)
            # and a real tail must differ from the zero pad for at
            # least one n (sanity that prev_tail_cls is actually
            # threaded through, not silently dropped on both paths)
            base = _prepare(tables, data, 256)
            if not np.array_equal(np.asarray(host[0]),
                                  np.asarray(base[0])):
                differed = True
        assert differed, (pattern, cls.__name__)


def test_device_prep_3bit_bit_identical(monkeypatch):
    monkeypatch.setenv("SREGEX_PACK_BITS", "3")
    ast, _ = parse("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
    dfa = build_dfa(compile_regex(ast))
    tables = SpecTables(dfa)
    assert tables.bits == 3 and tables.cpw == 10
    rng = random.Random(33)
    for n in (1, 4096, 70001):
        data = bytes(rng.randrange(256) for _ in range(n))
        host = _prepare(tables, data, 300)
        dev = prepare_on_device(tables, data, 300)
        assert host[1:] == dev[1:]
        assert np.array_equal(np.asarray(host[0]), np.asarray(dev[0]))


def test_prepare_auto_device_input_below_min_routes_to_device():
    """Round-5 regression: a jax.Array input (PreparedCorpus raw
    sharing, Scanner.precompile's device zeros stand-in) must take the
    DEVICE prep path even below DEVICE_PREP_MIN — the host path
    cannot read off-CPU buffers (np.frombuffer raises BufferError on
    an accelerator; CPU tests pin the routing + bit-identity instead)."""
    import jax.numpy as jnp
    import numpy as np
    from sregex_tpu import parse, compile_regex
    from sregex_tpu.dfa import build_dfa
    from sregex_tpu.ops.pallas_scan import SpecTables, _prepare
    from sregex_tpu.ops.prep import prepare_auto, DEVICE_PREP_MIN

    ast, _ = parse("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
    t = SpecTables(build_dfa(compile_regex(ast)))
    data = (b"abccc" * 4000)[:17000]
    assert len(data) < DEVICE_PREP_MIN
    host = _prepare(t, data, 512)
    dev = prepare_auto(t, jnp.asarray(np.frombuffer(data, np.uint8)),
                       512)
    assert host[1:] == dev[1:], (host[1:], dev[1:])
    assert np.array_equal(np.asarray(host[0]), np.asarray(dev[0]))
