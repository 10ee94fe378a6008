"""Device-side corpus preprocessing: raw uint8 shards go straight to
device memory; class-mapping, warmup windowing, sub-byte packing, and the
stream tiling all run as ONE fused XLA program on device.

Replaces the host prep (_prepare in pallas_scan.py: translate +
sliding windows + nibble pack + transpose), which costs seconds per
GiB of host CPU and uploads the packed array anyway; here the host
does nothing but the byte upload.

Design notes:
  - byte -> class is not a table gather: class maps are
    piecewise-constant over a handful of byte ranges (13-26 runs for
    typical patterns), so the map is a run-delta select chain —
    cls(b) = v0 + sum_r [b >= s_r] * d_r — pure elementwise work that
    XLA fuses into one pass over the bytes;
  - warmup windows never gather either: window c = [last W bytes of
    chunk c-1, chunk c], i.e. a reshape column slice + concat;
  - packing is a weighted sum over the CPW minor axis (non-overlapping
    bit fields: int32 wraparound on the top field is bit-exact);
  - the [Cp, Jw] -> [B, Jw, G, 8, 128] stream tiling is a plain
    transpose (one relayout pass).

The output is bit-identical to the host _prepare (pinned by
tests/test_device_prep.py), so the scan kernels cannot tell which
path produced their input.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .pallas_scan import GROUPS, TILE, WORDS_PER_ITER, _prepare

# corpora at least this large use the device pipeline (host prep wins
# below it: a device round trip costs more than the host pass)
DEVICE_PREP_MIN = 16 << 20


def _class_runs(class_map):
    """Run-delta encoding of the 256-entry class map: (starts, deltas)
    with cls(b) = deltas[0] + sum_{r>=1} [b >= starts[r]] * deltas[r].
    """
    cm = class_map.astype(np.int32)
    starts = [0]
    deltas = [int(cm[0])]
    for b in range(1, 256):
        if cm[b] != cm[b - 1]:
            starts.append(b)
            deltas.append(int(cm[b]) - int(cm[b - 1]))
    return (np.asarray(starts, dtype=np.int32),
            np.asarray(deltas, dtype=np.int32))


@functools.partial(jax.jit,
                   static_argnames=("K", "W", "B", "CPW", "BITS",
                                    "nruns", "cb"))
def _device_pack_pair(raw, n, starts, deltas, tail_cls, *, K, W, B,
                      CPW, BITS, nruns, cb):
    """Pair-unit device prep (ops/pallas_pair.py tables): class-map,
    combine adjacent classes into pair ids (elementwise — K and W are
    even so pairs never straddle windows), then window/pack in pair
    units.  Bit-identical to the host _prepare_pair.

    tail_cls: uint8 [W] class ids filling chunk 0's warmup window
    (all-zeros == the historical zero-class pad; real bytes for the
    pipelined streaming scan's non-first segments)."""
    G = GROUPS
    Cp = B * G * TILE
    x = raw.astype(jnp.int32)
    cls = jnp.full(x.shape, int(0), jnp.int32) + deltas[0]
    for r in range(1, nruns):
        cls = cls + jnp.where(x >= starts[r], deltas[r], 0)
    cls = jnp.where(
        lax.broadcasted_iota(jnp.int32, x.shape, 0) < n, cls, 0)
    pair = (cls[0::2] * cb + cls[1::2]).astype(jnp.uint8)
    K2, W2 = K // 2, W // 2
    J2 = W2 + K2
    tail32 = tail_cls.astype(jnp.int32)
    tail_pair = (tail32[0::2] * cb + tail32[1::2]).astype(jnp.uint8)
    pair = jnp.concatenate([tail_pair, pair])
    chunks = pair[W2:].reshape(Cp, K2)
    warm = pair[:Cp * K2].reshape(Cp, K2)[:, :W2]
    win = jnp.concatenate([warm, chunks], axis=1)      # [Cp, J2] u8
    words = win[:, 0::CPW].astype(jnp.int32)
    for k in range(1, CPW):
        words = words | (win[:, k::CPW].astype(jnp.int32)
                         << jnp.int32(BITS * k))
    words = words.reshape(B, G, TILE, J2 // CPW)
    words = jnp.transpose(words, (0, 3, 1, 2))
    return words.reshape(B, J2 // CPW, G, 8, 128)


@functools.partial(jax.jit,
                   static_argnames=("K", "W", "B", "CPW", "BITS",
                                    "nruns"))
def _device_pack(raw, n, starts, deltas, tail_cls, *, K, W, B, CPW,
                 BITS, nruns):
    """raw: uint8 [B*G*TILE*K] on device (padded to the block
    bucket); n: traced valid-byte count; tail_cls: uint8 [W] class
    ids for chunk 0's warmup window (zeros == the historical pad).
    Returns int32 [B, (W+K)//CPW, G, 8, 128] packed exactly like the
    host prep.

    n is traced (not static) so every corpus length within the same
    block bucket shares ONE compiled program — the scan kernel's
    shapes are keyed by B alone, and the prep now matches."""
    G = GROUPS
    Cp = B * G * TILE
    J = W + K
    x = raw.astype(jnp.int32)
    # byte -> class: run-delta select chain (elementwise, fuses);
    # stored as uint8 so the big intermediates stay 1 byte/byte
    # (class ids < 256 by construction)
    cls = jnp.full(x.shape, int(0), jnp.int32) + deltas[0]
    for r in range(1, nruns):
        cls = cls + jnp.where(x >= starts[r], deltas[r], 0)
    # beyond n: literal class id 0 — identical to the host prep's
    # zero padding (chunk 0's warmup is frozen via j0; chunks past C
    # are masked in the fold; the ragged tail chunk is forced native
    # via bad_tail)
    cls = jnp.where(
        lax.broadcasted_iota(jnp.int32, x.shape, 0) < n, cls, 0)
    cls = cls.astype(jnp.uint8)
    cls = jnp.concatenate([tail_cls, cls])
    chunks = cls[W:].reshape(Cp, K)
    warm = cls[:Cp * K].reshape(Cp, K)[:, :W]
    win = jnp.concatenate([warm, chunks], axis=1)      # [Cp, J] u8
    # pack CPW BITS-bit classes per int32 word (bit fields never
    # overlap, so int32 wraparound on the top field is bit-exact).
    # Accumulate over strided 2-D slices rather than reshape+reduce:
    # the slices stay plain [Cp, Jw] planes (no [Cp, Jw, CPW]
    # intermediate with a tiny minor dimension)
    words = win[:, 0::CPW].astype(jnp.int32)
    for k in range(1, CPW):
        words = words | (win[:, k::CPW].astype(jnp.int32)
                         << jnp.int32(BITS * k))       # [Cp, Jw]
    # stream tiling: chunk c = ((b*G + g)*TILE + t)
    words = words.reshape(B, G, TILE, J // CPW)
    words = jnp.transpose(words, (0, 3, 1, 2))
    return words.reshape(B, J // CPW, G, 8, 128)


def prepare_on_device(tables, data_np, chunk_len, b_multiple=1,
                      prev_tail_cls=None, block=True):
    """Device-side analogue of _prepare: same (dev, C, K, J, B) tuple,
    bit-identical packed array, but the host only uploads raw bytes.
    data_np may already be a device-resident uint8 array (jax.Array),
    in which case no host work or transfer happens at all.

    prev_tail_cls / block: see _prepare (the pipelined streaming
    scan fills chunk 0's warmup with real prior-segment bytes and
    defers the sync so uploads overlap scans)."""
    n = len(data_np)
    CPW = tables.cpw
    bpu = getattr(tables, "bpu", 1)
    from .pallas_scan import effective_chunk
    K = effective_chunk(tables, chunk_len)
    W = tables.warmup
    G = GROUPS
    C = max(1, -(-n // K))
    B = -(-C // (G * TILE))
    B = -(-B // b_multiple) * b_multiple

    L = B * G * TILE * K
    if L >= 2 ** 31:
        # the valid-byte iota mask is int32; beyond 2 GiB of padded
        # corpus fall back to host prep (exact, just slower) — which
        # needs host bytes even when the caller shares a device-
        # resident raw array (PreparedCorpus._raw)
        if isinstance(data_np, jax.Array):
            data_np = np.asarray(data_np)
        return _prepare(tables, data_np, chunk_len,
                        b_multiple=b_multiple,
                        prev_tail_cls=prev_tail_cls, block=block)
    if isinstance(data_np, jax.Array):
        raw = jnp.pad(data_np, (0, L - n))
    else:
        if not isinstance(data_np, np.ndarray):
            data_np = np.frombuffer(data_np, dtype=np.uint8)
        raw = np.zeros(L, dtype=np.uint8)
        raw[:n] = data_np
    starts, deltas = _class_runs(tables.class_map)
    if prev_tail_cls is None:
        tail_cls = np.zeros(W, dtype=np.uint8)
    else:
        tail_cls = np.asarray(prev_tail_cls, dtype=np.uint8)
    if bpu == 2:
        dev = _device_pack_pair(jnp.asarray(raw), jnp.int32(n),
                                jnp.asarray(starts),
                                jnp.asarray(deltas),
                                jnp.asarray(tail_cls),
                                K=K, W=W, B=B, CPW=CPW,
                                BITS=tables.bits, nruns=len(starts),
                                cb=tables.byte_ncls)
    else:
        dev = _device_pack(jnp.asarray(raw), jnp.int32(n),
                           jnp.asarray(starts), jnp.asarray(deltas),
                           jnp.asarray(tail_cls),
                           K=K, W=W, B=B, CPW=CPW, BITS=tables.bits,
                           nruns=len(starts))
    if block:
        dev.block_until_ready()
    return dev, C, K, W + K, B


def prepare_auto(tables, data_np, chunk_len, b_multiple=1,
                 prev_tail_cls=None, block=True):
    """Pick the prep path: device pipeline for large corpora (the
    upload is the only host work), host prep for small ones (one
    dispatch round-trip costs more than the host pass).  Env override:
    SREGEX_DEVICE_PREP=1 forces device, =0 forces host."""
    knob = os.environ.get("SREGEX_DEVICE_PREP")
    use_dev = (len(data_np) >= DEVICE_PREP_MIN if knob is None
               else knob == "1")
    import jax
    if isinstance(data_np, jax.Array):
        # device-resident input (PreparedCorpus raw sharing,
        # Scanner.precompile's device zeros stand-in): the host path
        # cannot read it (no buffer protocol off-CPU) — always prep
        # on device, whatever the size knob says
        use_dev = True
    if use_dev:
        return prepare_on_device(tables, data_np, chunk_len,
                                 b_multiple=b_multiple,
                                 prev_tail_cls=prev_tail_cls,
                                 block=block)
    return _prepare(tables, data_np, chunk_len, b_multiple=b_multiple,
                    prev_tail_cls=prev_tail_cls, block=block)
