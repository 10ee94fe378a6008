"""Hot-core TDFA projection (ops/tdfa_scan.TdfaCoreTables): one-pass
device captures for tagged machines past the dense kernel budget.
Exactness contract: every certified result byte-equals the Pike
oracle; escapes re-walk on the host TDFA inside the chunk-repair
fold; uncertifiable results return "fallback" (the caller's
multi-pass path), never a wrong answer."""

import random
import re

import numpy as np
import pytest

from sregex_tpu.stream import compile_pattern
from sregex_tpu.tdfa import TdfaTooLarge
from sregex_tpu.ops.tdfa_scan import TdfaSpecTables, TdfaCoreTables


# past the 512-entry CPU dense budget (register blowup on the counted
# rep), tiny hot set on a match-free corpus
PAT = rb"(a{150,300})b"


def _corpus(n, plant_at=None, seed=3):
    rng = random.Random(seed)
    data = bytearray(rng.choice(b"xyz mnpq") for _ in range(n))
    if plant_at is not None:
        data[plant_at:plant_at + 201] = b"a" * 200 + b"b"
    return bytes(data)


def test_dense_declines_core_accepts():
    sc = compile_pattern(PAT)
    with pytest.raises(TdfaTooLarge):
        TdfaSpecTables(sc.program)
    ct = TdfaCoreTables(sc.program, _corpus(1 << 16))
    assert ct.is_core
    assert ct.H >= 1 and ct.nstates == ct.H + 1
    # ESC is a self-loop sink
    esc = ct.esc_k
    nxt = np.asarray(ct.t_next)        # flat [rows * 128]
    for c in range(ct.ncls):
        assert int(nxt[esc * ct.ncls + c]) == esc * ct.ncls


def test_core_find_exact_with_escape_repair():
    sc = compile_pattern(PAT, use_device=True)
    sc.DEVICE_THRESHOLD = 1 << 16
    assert sc._tdfa_spec is None
    n = 1 << 20
    # plant between the _core_sample windows ({0, n/3, 2n/3, n-w}
    # each w=256K wide) so the sampled hot set stays match-free
    data = _corpus(n, plant_at=620_000)
    m = re.search(PAT, data)
    got = sc.find(data)
    assert got is not None
    assert got[0] == 0
    assert got[1][:4] == [m.start(), m.end(), m.start(1), m.end(1)]
    ct = sc._tdfa_coret
    assert isinstance(ct, TdfaCoreTables), type(ct)
    # and the kernel path itself (not the multi-pass fallback)
    r = sc._tdfa_find(data, tables=ct)
    assert r is not None
    assert r[0] == 0
    assert r[1][:4] == [m.start(), m.end(), m.start(1), m.end(1)]


def test_core_find_certified_no_match():
    sc = compile_pattern(PAT, use_device=True)
    sc.DEVICE_THRESHOLD = 1 << 16
    data = _corpus(1 << 20)
    assert sc.find(data) is None
    ct = sc._tdfa_coret
    if ct:
        assert sc._tdfa_find(data, tables=ct) == (-1, None)


def test_core_escape_heavy_falls_back_exact():
    """A corpus littered with matches blows the repair budget: the
    kernel path declines ('fallback' -> None) and find() stays exact
    via the multi-pass path."""
    sc = compile_pattern(PAT, use_device=True)
    sc.DEVICE_THRESHOLD = 1 << 16
    clean = _corpus(1 << 20)
    sc.find(clean)                   # build the core from clean data
    ct = sc._tdfa_coret
    if not ct:
        pytest.skip("core declined on this sample")
    rng = random.Random(9)
    data = bytearray(_corpus(1 << 20, seed=11))
    for _ in range(200):             # match-dense: most chunks escape
        at = rng.randrange(0, len(data) - 202)
        data[at:at + 201] = b"a" * 200 + b"b"
    data = bytes(data)
    m = re.search(PAT, data)
    got = sc.find(data)
    assert got is not None and got[1][:2] == [m.start(), m.end()]


def test_core_multi_regex_ids():
    pats = [rb"(x{60,200})y", rb"(q{60,200})r"]
    sc = compile_pattern(pats, use_device=True)
    sc.DEVICE_THRESHOLD = 1 << 16
    n = 1 << 20
    rng = random.Random(5)
    data = bytearray(rng.choice(b"ab cd ef") for _ in range(n))
    data[n // 2:n // 2 + 81] = b"q" * 80 + b"r"
    data = bytes(data)
    got = sc.find(data)
    assert got is not None
    assert got[0] == 1                        # second regex
    assert got[1][:2] == [n // 2, n // 2 + 81]
