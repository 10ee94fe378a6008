"""Dispatch-time device degradation (VERDICT r3 #1b / #5): a kernel
that only fails at its FIRST compile/dispatch (an out-of-memory
compile, say — tier construction succeeds, the compile explodes) must
not crash the scan API.  The Scanner must complete the scan at host
rate with a loud RuntimeWarning, decline the failing tier for its
lifetime, and raise only under SREGEX_STRICT_DEVICE=1.

The reference's contract is the model: sre_vm_pike.c:165-168 returns
SRE_ERROR, never aborts, regardless of machine shape.
"""

import random
import warnings

import pytest

from sregex_tpu import parse, compile_regex
from sregex_tpu.stream import Scanner
from sregex_tpu import diag


class FakeXlaRuntimeError(Exception):
    """Stand-in for jaxlib's XlaRuntimeError (remote-compile OOM)."""


def _scanner(pattern="(?:a|b)aa(?:aa|bb)cc(?:a|b)"):
    ast, _ = parse(pattern)
    prog = compile_regex(ast)
    sc = Scanner(prog, use_device=True, ast=ast)
    sc.DEVICE_THRESHOLD = 1 << 12
    return sc


def _corpus(n=200_000, seed=11):
    rng = random.Random(seed)
    return bytes(rng.choice(b"abc ") for _ in range(n))


def _boom(*a, **k):
    raise FakeXlaRuntimeError(
        "Out of memory while trying to allocate (simulated)")


def test_count_survives_spec_dispatch_failure(monkeypatch):
    data = _corpus()
    ref = _scanner().count(data)            # healthy device answer
    sc = _scanner()
    assert sc._spec is not None
    diag.reset_warned()
    monkeypatch.setattr("sregex_tpu.ops.pallas_scan.spec_count_bytes",
                        _boom)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = sc.count(data)
    assert got == ref
    assert any("device dispatch failed" in str(x.message) for x in w)
    assert sc._spec is None                 # tier declined for life
    assert sc.stats().tier == "native"
    # second scan: no second warning (warn-once latch), still correct
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        assert sc.count(data) == ref
    assert not any("device dispatch failed" in str(x.message)
                   for x in w2)


def test_scan_survives_spec_dispatch_failure(monkeypatch):
    data = _corpus(seed=12)
    ref = _scanner().scan(data)
    sc = _scanner()
    diag.reset_warned()
    monkeypatch.setattr("sregex_tpu.ops.pallas_scan.spec_scan_bytes",
                        _boom)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert sc.scan(data) == ref
    assert any("device dispatch failed" in str(x.message) for x in w)


def test_strict_device_raises_at_dispatch(monkeypatch):
    sc = _scanner()
    diag.reset_warned()
    monkeypatch.setattr("sregex_tpu.ops.pallas_scan.spec_count_bytes",
                        _boom)
    monkeypatch.setenv("SREGEX_STRICT_DEVICE", "1")
    with pytest.raises(RuntimeError, match="degradation"):
        sc.count(_corpus(seed=13))


def test_core_dispatch_failure_falls_to_static_then_native(
        monkeypatch):
    # big-machine pattern: the static chain lands on the big tier and
    # the adaptive core tier engages on top — kill the core dispatch
    # and the scan must still complete exactly
    pat = "b(?:[ab]{230})a"
    data = _corpus(seed=14)
    ref = _scanner(pat).count(data)
    sc = _scanner(pat)
    diag.reset_warned()
    monkeypatch.setattr("sregex_tpu.ops.pallas_core.core_count_bytes",
                        _boom)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = sc.count(data)
    assert got == ref
    # this pattern exceeds the eager-DFA budget, so the dispatching
    # tier is the lazy-backed core (LazyCoreTables via _lazy_coret);
    # the failed dispatch must have declined it for life and warned
    assert getattr(sc, "_lazy_coret", None) is False
    assert any("device dispatch failed" in str(x.message) for x in w)


# ---------------------------------------------------------------------
# Fused two-phase dispatch (VERDICT r4 #5): the fused tier has its own
# decline semantics — a RAISING dispatch degrades loudly and declines
# `_fusedct` for the Scanner's lifetime; a None RETURN (shape
# disqualification) declines silently.  Either way the scan completes
# exactly on the next tier down.
# ---------------------------------------------------------------------

def _fused_scanner(seed=2):
    """Keyword-set Scanner whose static tier is a long-chain wide on
    the CPU mesh, so Scanner.count routes through the fused two-phase
    dispatch (same machine family as tests/test_fused_count.py)."""
    from sregex_tpu import parse_multi
    rng = random.Random(seed)
    words = list({("".join(rng.choice("abcdefghijklmn")
                           for _ in range(4))).encode()
                  for _ in range(14)})
    ast, _ = parse_multi(words)
    prog = compile_regex(ast)
    sc = Scanner(prog, use_device=True, ast=ast)
    sc.DEVICE_THRESHOLD = 1 << 12
    return sc, words


def _fused_corpus(words, n=200_000, seed=7):
    rng = random.Random(seed)
    filler = [("".join(rng.choice("nopqrstuv") for _ in range(5)))
              .encode() for _ in range(12)]
    piece = b" ".join(rng.choice(filler) for _ in range(64)) + b" "
    out = bytearray((piece * (n // len(piece) + 1))[:n])
    for pos in range(8192, n - 16, 8192):
        w = words[rng.randrange(len(words))]
        out[pos:pos + len(w) + 2] = b" " + w + b" "
    return bytes(out)


def test_count_survives_fused_dispatch_failure(monkeypatch):
    sc0, words = _fused_scanner()
    data = _fused_corpus(words)
    ref = sc0.count(data)                  # healthy device answer
    assert sc0._fusedct not in (None, False), "fused tier not engaged"

    sc, _ = _fused_scanner()
    diag.reset_warned()
    monkeypatch.setattr("sregex_tpu.ops.pallas_core.core_count_fused",
                        _boom)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = sc.count(data)
    assert got == ref
    assert any("device dispatch failed" in str(x.message) for x in w)
    # fused tier declined for life; the scan was served by the next
    # tier down (legacy core or the static wide tier), not native
    assert sc._fusedct is False
    assert sc.stats().tier in ("CoreTables", "SpecTablesWide")
    # second scan: no second warning (warn-once latch), still correct
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        assert sc.count(data) == ref
    assert not any("device dispatch failed" in str(x.message)
                   for x in w2)


def test_scan_survives_fused_dispatch_failure(monkeypatch):
    sc0, words = _fused_scanner(seed=3)
    data = _fused_corpus(words, seed=8)
    ref = sc0.scan(data)
    sc, _ = _fused_scanner(seed=3)
    diag.reset_warned()
    monkeypatch.setattr("sregex_tpu.ops.pallas_core.core_scan_fused",
                        _boom)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert sc.scan(data) == ref
    assert any("device dispatch failed" in str(x.message) for x in w)
    assert sc._fusedct is False


def test_fused_none_return_declines_silently(monkeypatch):
    """core_count_fused returning None (shape disqualification, e.g.
    differing effective chunk between the two preps) must decline the
    tier WITHOUT a degradation warning and fall through exactly."""
    sc0, words = _fused_scanner()
    data = _fused_corpus(words)
    ref = sc0.count(data)
    sc, _ = _fused_scanner()
    diag.reset_warned()
    monkeypatch.setattr("sregex_tpu.ops.pallas_core.core_count_fused",
                        lambda *a, **k: None)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = sc.count(data)
    assert got == ref
    assert sc._fusedct is False
    assert not any("device dispatch failed" in str(x.message)
                   for x in w)


def test_fused_strict_device_raises_at_dispatch(monkeypatch):
    sc, words = _fused_scanner()
    assert sc._fused_core_tables(_fused_corpus(words)) is not None
    diag.reset_warned()
    monkeypatch.setattr("sregex_tpu.ops.pallas_core.core_count_fused",
                        _boom)
    monkeypatch.setenv("SREGEX_STRICT_DEVICE", "1")
    with pytest.raises(RuntimeError, match="degradation"):
        sc.count(_fused_corpus(words))
