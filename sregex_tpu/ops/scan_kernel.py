"""The chunk walk: the one device hot loop under every table tier.

Every speculative tier (narrow, wide, big, pair, and both phases of the
fused core tier) reduces to the same per-chunk work.  A chunk is one
stream of packed class ids; the stream advances through a flat table

    table[state + cls] = (next * ncls) | (match_count << 20)

(``state`` premultiplied by ncls), first through a warmup window with
a per-stream freeze predicate (j >= j0), then through the chunk body
while a COUNT (sum) or OR accumulator records the match bits.  Per
stream the walk returns the exit state (phi), the accumulator (fm) and
the speculated entry at the end of the warmup (swarm).

Three implementations share that contract bit for bit:

  - ``"triton"``: a Pallas kernel compiled for NVIDIA GPUs through
    Triton.  One program walks BS streams; each stream's state stays
    in registers for the whole chunk and every table lookup is a
    pointer gather (the table stays in L1/L2).
  - ``"plain"``: jax.numpy/lax over all streams at once — a fori_loop
    over packed words with one gather per byte.  The CPU path and the
    reference the kernel is checked against.
  - ``"interpret"``: the Pallas kernel run by the Pallas interpreter
    (CPU tests of the kernel body).

The choice lives in ``implementation()`` and nowhere else.

Data layout: ``data`` int32 [B, Jw, G, 8, 128] (word j of 1024*G
streams contiguous, so the kernel's per-word loads coalesce),
``state0``/``j0`` and the three outputs int32 [B, G, 8, 128].
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
from jax import lax

MATCH_SHIFT = 20
STATE_MASK = (1 << MATCH_SHIFT) - 1

# the implementation GPUs run (the faster one end to end on an H100:
# PERF.md "Kernel decisions")
GPU_IMPL = "triton"
IMPLS = ("triton", "plain", "interpret")

# Triton launch shape: streams per program and warps per program
# (128-512 streams with 2-8 warps all walk within noise of each other
# on an H100: PERF.md)
BLOCK_STREAMS = 512
NUM_WARPS = 4

_forced = []


def implementation():
    """The walk implementation for the default backend: ``gpu`` runs
    GPU_IMPL, ``cpu`` the plain version (or what a test forces with
    ``forced_implementation``); any other backend is an error."""
    if _forced:
        return _forced[-1]
    backend = jax.default_backend()
    if backend == "gpu":
        return GPU_IMPL
    if backend == "cpu":
        return "plain"
    raise RuntimeError("no chunk-walk implementation for backend %r"
                       % backend)


@contextlib.contextmanager
def forced_implementation(impl):
    """Run the enclosed scans with one implementation (tests)."""
    if impl not in IMPLS:
        raise ValueError("unknown implementation %r" % (impl,))
    _forced.append(impl)
    try:
        yield
    finally:
        _forced.pop()


def table_size(entries):
    """Flat-table length for ``entries`` live entries: a power of two,
    at least 128 (Triton tensors and loads are power-of-two shaped)."""
    return max(128, 1 << max(0, int(entries) - 1).bit_length())


def walk(data, state0, j0, table, flags=None, *, W, CPW, BITS, COUNT,
         impl=None, block=None):
    """Walk every stream of ``data`` through ``table``.

    W: warmup length in kernel units (bytes, or byte pairs for the
    pair tier), a multiple of CPW.  ``flags`` (optional int32 [B]):
    blocks whose flag is 0 skip the walk and return zeros.  Returns
    (phi, fm, swarm), each int32 [B, G, 8, 128]; fm is the per-chunk
    match count (COUNT) or the any-match flag.  ``block`` overrides
    BLOCK_STREAMS (streams per Pallas program)."""
    impl = impl or implementation()
    if impl == "plain":
        return _walk_plain(data, state0, j0, table, flags, W=W, CPW=CPW,
                           BITS=BITS, COUNT=COUNT)
    return _walk_pallas(data, state0, j0, table, flags, W=W, CPW=CPW,
                        BITS=BITS, COUNT=COUNT,
                        interpret=impl == "interpret",
                        BS=block or BLOCK_STREAMS)


def table_step(table):
    """The table tiers' byte step for ``walk_plain_step``."""
    def step(state, cls):
        e = jnp.take(table, state + cls, mode="clip")
        return e & STATE_MASK, e >> MATCH_SHIFT
    return step


def walk_plain_step(data, state0, j0, step, *, W, CPW, BITS, COUNT):
    """Plain walk over any byte step ``step(state, cls) -> (next,
    match)`` (the affine tier brings its own).  Vectorized over all
    streams; one fori_loop iteration per packed word."""
    cmask = (1 << BITS) - 1
    nwarm = W // CPW
    nhot = data.shape[1] - nwarm

    def word_at(w):
        return lax.dynamic_index_in_dim(data, w, axis=1, keepdims=False)

    def warm(wi, st):
        word = word_at(wi)
        for k in range(CPW):
            nxt, _ = step(st, (word >> (BITS * k)) & cmask)
            st = jnp.where(wi * CPW + k >= j0, nxt, st)
        return st

    st = lax.fori_loop(0, nwarm, warm, state0)
    swarm = st

    def hot(w, carry):
        st, acc = carry
        word = word_at(nwarm + w)
        for k in range(CPW):
            st, m = step(st, (word >> (BITS * k)) & cmask)
            acc = acc + m if COUNT else acc | m
        return st, acc

    st, acc = lax.fori_loop(0, nhot, hot, (st, jnp.zeros_like(st)))
    return st, acc, swarm


def _walk_plain(data, state0, j0, table, flags, *, W, CPW, BITS, COUNT):
    phi, fm, swarm = walk_plain_step(data, state0, j0, table_step(table),
                                     W=W, CPW=CPW, BITS=BITS, COUNT=COUNT)
    if flags is not None:
        on = (flags != 0)[:, None, None, None]
        phi, fm, swarm = (jnp.where(on, x, 0) for x in (phi, fm, swarm))
    return phi, fm, swarm


def _kernel(*refs, NWARM, NHOT, CPW, BITS, COUNT, GATED, BS):
    """One program: BS streams of one block, walked word by word.  The
    data ref spans the block's whole window ([Jw, BS]); nothing carries
    between programs, so the launch order is irrelevant."""
    from jax.experimental import pallas as pl
    if GATED:
        (data_ref, s0_ref, j0_ref, table_ref, flags_ref,
         phi_ref, fm_ref, swarm_ref) = refs
    else:
        (data_ref, s0_ref, j0_ref, table_ref,
         phi_ref, fm_ref, swarm_ref) = refs
    cmask = (1 << BITS) - 1

    def body():
        j0 = j0_ref[...]

        def warm(wi, st):
            word = data_ref[wi, :]
            for k in range(CPW):
                e = table_ref[st + ((word >> (BITS * k)) & cmask)]
                st = jnp.where(wi * CPW + k >= j0, e & STATE_MASK, st)
            return st

        st = lax.fori_loop(0, NWARM, warm, s0_ref[...])
        swarm_ref[...] = st

        def hot(w, carry):
            st, acc = carry
            word = data_ref[NWARM + w, :]
            for k in range(CPW):
                e = table_ref[st + ((word >> (BITS * k)) & cmask)]
                acc = acc + (e >> MATCH_SHIFT) if COUNT else acc | e
                st = e & STATE_MASK
            return st, acc

        st, acc = lax.fori_loop(0, NHOT, hot,
                                (st, jnp.zeros((BS,), jnp.int32)))
        phi_ref[...] = st
        fm_ref[...] = acc if COUNT else acc >> MATCH_SHIFT

    if not GATED:
        body()
        return
    on = flags_ref[pl.program_id(0)] != 0

    @pl.when(on)
    def _():
        body()

    @pl.when(jnp.logical_not(on))
    def _():
        z = jnp.zeros((BS,), jnp.int32)
        phi_ref[...] = z
        fm_ref[...] = z
        swarm_ref[...] = z


@functools.partial(jax.jit, static_argnames=(
    "W", "CPW", "BITS", "COUNT", "interpret", "BS"))
def _walk_pallas(data, state0, j0, table, flags, *, W, CPW, BITS, COUNT,
                 interpret, BS):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton
    B, Jw, G = data.shape[0], data.shape[1], data.shape[2]
    N = G * 8 * 128
    BS = min(BS, N)
    gated = flags is not None
    kernel = functools.partial(
        _kernel, NWARM=W // CPW, NHOT=Jw - W // CPW, CPW=CPW, BITS=BITS,
        COUNT=COUNT, GATED=gated, BS=BS)
    plane = pl.BlockSpec((None, BS), lambda b, s: (b, s))
    in_specs = [
        pl.BlockSpec((None, Jw, BS), lambda b, s: (b, 0, s)),
        plane, plane,
        pl.BlockSpec(table.shape, lambda b, s: (0,)),
    ]
    args = [data.reshape(B, Jw, N), state0.reshape(B, N),
            j0.reshape(B, N), table]
    if gated:
        in_specs.append(pl.BlockSpec(flags.shape, lambda b, s: (0,)))
        args.append(flags.astype(jnp.int32))
    out = jax.ShapeDtypeStruct((B, N), jnp.int32)
    phi, fm, swarm = pl.pallas_call(
        kernel,
        grid=(B, N // BS),
        in_specs=in_specs,
        out_specs=[plane, plane, plane],
        out_shape=[out, out, out],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="chunk_walk",
    )(*args)
    shape = (B, G, 8, 128)
    return phi.reshape(shape), fm.reshape(shape), swarm.reshape(shape)
