"""The chunk walk (ops/scan_kernel.py): the GPU kernel body run by the
Pallas interpreter against the plain reference, bit for bit, across
table sizes, packings, pair units, COUNT/OR modes, the core tier's ESC
check and the gate flags; the choice of implementation; and (marked
``gpu``) the compiled Triton kernel on a card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sregex_tpu.ops import scan_kernel as sk
from sregex_tpu.ops.pallas_scan import (GROUPS, _MATCH_SHIFT,
                                        _spec_scan, flat_table)


def _machine(rng, entries, ncls, pair=False):
    """Random transition table with ``entries`` = S * ncls live
    entries; match counts 0..1 (0..2 for pair units)."""
    S = max(1, entries // ncls)
    trans = rng.integers(0, S, size=(S, ncls))
    match = rng.integers(0, 3 if pair else 2, size=(S, ncls)) \
        * (rng.random((S, ncls)) < 0.2)
    return S, flat_table(trans, match, ncls)


def _data(rng, ncls, bits, W, K, B=1):
    cpw = 32 // bits if bits != 4 else 8
    jw = (W + K) // cpw
    cls = rng.integers(0, ncls, size=(B, jw, GROUPS, 8, 128, cpw))
    words = np.zeros((B, jw, GROUPS, 8, 128), np.uint64)
    for k in range(cpw):
        words |= cls[..., k].astype(np.uint64) << np.uint64(bits * k)
    return cpw, jnp.asarray(words.astype(np.uint32).view(np.int32))


def _planes(rng, S, ncls, W, B=1):
    shape = (B, GROUPS, 8, 128)
    s0 = jnp.asarray(rng.integers(0, S, size=shape) * ncls, jnp.int32)
    j0 = jnp.asarray(rng.integers(0, W + 1, size=shape), jnp.int32)
    return s0, j0


def _both(data, s0, j0, table, flags=None, **kw):
    ref = sk.walk(data, s0, j0, table, flags, impl="plain", **kw)
    got = sk.walk(data, s0, j0, table, flags, impl="interpret",
                  block=1024, **kw)
    return [np.asarray(x) for x in ref], [np.asarray(x) for x in got]


@pytest.mark.parametrize("count", [True, False], ids=["count", "or"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("entries", [128, 4096, 12447])
def test_kernel_matches_plain(entries, bits, count):
    rng = np.random.default_rng(entries * 10 + bits)
    ncls = 16 if bits == 4 else 27
    if entries == 128 and bits == 8:
        ncls = 32
    S, table = _machine(rng, entries, ncls)
    W = 16 if bits == 8 else 32
    cpw, data = _data(rng, ncls, bits, W, 64)
    s0, j0 = _planes(rng, S, ncls, W)
    ref, got = _both(data, s0, j0, table, W=W, CPW=cpw, BITS=bits,
                     COUNT=count)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    assert ref[1].any()                   # some chunk matched
    if not count:
        assert set(np.unique(ref[1])) <= {0, 1}


@pytest.mark.parametrize("count", [True, False], ids=["count", "or"])
def test_kernel_pair_units(count):
    """Pair tables: 2-bit match counts, W/j0 in pair units."""
    rng = np.random.default_rng(5)
    npair = 9
    S, table = _machine(rng, 90, npair, pair=True)
    W = 32
    cpw, data = _data(rng, npair, 4, W, 64)
    s0, j0 = _planes(rng, S, npair, W)
    ref, got = _both(data, s0, j0, table, W=W, CPW=cpw, BITS=4,
                     COUNT=count)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    if count:
        assert ref[1].max() >= 2          # two boundaries per step


@pytest.mark.parametrize("flags", ["on", "alternate", "off"])
def test_kernel_gate_flags(flags):
    rng = np.random.default_rng(9)
    S, table = _machine(rng, 4096, 27)
    W, B = 16, 2
    cpw, data = _data(rng, 27, 8, W, 32, B=B)
    s0, j0 = _planes(rng, S, 27, W, B=B)
    f = {"on": [1, 1], "alternate": [0, 1], "off": [0, 0]}[flags]
    f = jnp.asarray(f, jnp.int32)
    ref, got = _both(data, s0, j0, table, f, W=W, CPW=cpw, BITS=8,
                     COUNT=True)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    ungated = sk.walk(data, s0, j0, table, W=W, CPW=cpw, BITS=8,
                      COUNT=True, impl="plain")
    for blk in range(B):
        for r, u in zip(ref, ungated):
            if int(f[blk]):
                np.testing.assert_array_equal(r[blk], np.asarray(u)[blk])
            else:
                assert not r[blk].any()


@pytest.mark.parametrize("count", [True, False], ids=["count", "or"])
def test_kernel_esc_summary(count):
    """The core tier's sticky escape state: chunks ending in ESC fail
    validation in the on-device summary, identically for both
    implementations."""
    rng = np.random.default_rng(13)
    ncls, S = 16, 8
    trans = rng.integers(0, S, size=(S, ncls))
    trans[S - 1] = S - 1                  # ESC: sticky self-loop
    trans[0, 15] = S - 1                  # class 15 escapes from 0
    match = (rng.random((S, ncls)) < 0.1).astype(np.int64)
    table = flat_table(trans, match, ncls)
    W = 32
    cpw, data = _data(rng, ncls, 4, W, 64)
    s0, j0 = _planes(rng, S, ncls, W)
    esc = (S - 1) * ncls
    outs = [_spec_scan(data, s0, j0, table, jnp.int32(4000),
                       jnp.int32(-1), W=W, CPW=cpw, BITS=4, COUNT=count,
                       PACK8=True, ESC=esc, IMPL=impl)
            for impl in ("plain", "interpret")]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    phi = np.asarray(outs[0][1])[0]
    assert (phi == esc).any()             # some chunk escaped


def test_implementation_choice(monkeypatch):
    assert sk.implementation() == "plain"          # this CPU run
    with sk.forced_implementation("interpret"):
        assert sk.implementation() == "interpret"
    assert sk.implementation() == "plain"
    with pytest.raises(ValueError):
        with sk.forced_implementation("mosaic"):
            pass
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert sk.implementation() == sk.GPU_IMPL
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError):
        sk.implementation()


@pytest.mark.parametrize("entries,size", [(1, 128), (128, 128),
                                          (129, 256), (12447, 16384),
                                          (1 << 17, 1 << 17)])
def test_table_size_power_of_two(entries, size):
    assert sk.table_size(entries) == size


def test_flat_table_encoding():
    trans = np.array([[1, 0], [1, 1]])
    match = np.array([[0, 1], [2, 0]])
    t = np.asarray(flat_table(trans, match, 2))
    assert t.shape == (128,)
    assert list(t[:4]) == [2, 0 | (1 << _MATCH_SHIFT),
                           2 | (2 << _MATCH_SHIFT), 2]
    assert not t[4:].any()


@pytest.fixture
def gpu():
    """The GPU this test needs; skips where JAX has none (the suite
    forces the CPU unless SREGEX_TEST_GPU=1)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU: run `SREGEX_TEST_GPU=1 python -m "
                    "pytest -m gpu tests/` on a machine with one")
    return devs[0]


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
def test_triton_kernel_on_gpu(gpu, bits):
    """The compiled Triton kernel, bit-identical to the plain walk."""
    rng = np.random.default_rng(21)
    ncls = 16 if bits == 4 else 27
    S, table = _machine(rng, 12447, ncls)
    W = 32 if bits == 4 else 16
    cpw, data = _data(rng, ncls, bits, W, 2048, B=3)
    s0, j0 = _planes(rng, S, ncls, W, B=3)
    for flags in (None, jnp.asarray([1, 0, 1], jnp.int32)):
        ref = sk.walk(data, s0, j0, table, flags, W=W, CPW=cpw,
                      BITS=bits, COUNT=True, impl="plain")
        got = sk.walk(data, s0, j0, table, flags, W=W, CPW=cpw,
                      BITS=bits, COUNT=True, impl="triton")
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(r), np.asarray(g))
