"""Batched multi-document scan: ONE kernel dispatch over a whole set
of corpora.

The production serving shape is many independent documents (log
files, requests, records), each far too small to amortize a device
dispatch and readback on its own.  The reference's answer is simply
the host loop (sregex-cli processes one buffer per call, sregex.h exec
per ctx); an accelerator can do better: pack EVERY document into one
chunk stream and let a single walk scan them all.

How it stays exact with ZERO kernel changes: the speculative kernel
(pallas_scan.py) already treats every chunk independently — each
chunk speculates from state 0 through a warmup window and the chain
is validated on host.  A document boundary is exactly the "chunk 0"
situation, and chunk 0 is handled by the per-chunk (state0, j0)
planes: j0 = W freezes the stream through its warmup so it starts
LIVE at the true entry (the seed).  Batching therefore:

  - rounds each document up to whole chunks (pad bytes are chosen so
    their CLASS is 0 — bit-identical to the historical zero-class
    tail pad every tier already certifies against);
  - scatters j0 = W at every document-start chunk (the warmup window,
    which physically contains the previous document's tail, is frozen
    and irrelevant);
  - folds the validation chain PER DOCUMENT on host: entries restart
    at the seed, trusted full chunks decode from the kernel planes,
    missed chunks and each document's ragged tail chunk re-walk
    natively (pad bytes are never trusted).

Exactness is unconditional — the same speculation-validation contract
as the single-buffer path, applied per document.  Documents shorter
than one chunk fold natively (their only chunk is ragged); pass a
smaller chunk_len (the packing quantum is 16 bytes) to give small
documents device coverage.

Reference analog: none — sregex scans one buffer per exec call
(src/sregex/sre_vm_pike.c sre_vm_pike_exec).  This is accelerator
batch affinity applied to the reference's workload.
"""

import numpy as np
import jax
import jax.numpy as jnp

from .pallas_scan import (GROUPS, TILE, DEFAULT_K, _prepare, _unpack,
                          effective_chunk)


class BatchUnsupported(Exception):
    """The tier cannot serve a batched scan (no zero-class pad byte
    exists: every byte of the alphabet is structurally significant to
    the pattern)."""


def _pad_byte(tables):
    z = np.where(np.asarray(tables.class_map) == 0)[0]
    if len(z) == 0:
        raise BatchUnsupported("no zero-class byte to pad with")
    return int(z[0])


def _batch_entry_planes(w, starts, seed, *, B):
    """state0/j0 planes with the warmup frozen (j0 = W) at every
    document-start chunk; ALL entries are the seed premult (usually
    0; renumbered tiers map the seed elsewhere — tables.to_premult)."""
    G = GROUPS
    total = B * G * TILE
    s0 = jnp.full(total, seed, jnp.int32)
    j0 = jnp.zeros(total, jnp.int32).at[
        jnp.asarray(np.asarray(starts, dtype=np.int32))].set(w)
    return (s0.reshape(B, G, 8, 128), j0.reshape(B, G, 8, 128))


class PreparedBatch:
    """Pack/upload of a document SET done once (the batch analogue of
    PreparedCorpus): reuse across count_many/scan_many calls on the
    SAME Scanner and document list — the pad/upload cost is paid once
    and every subsequent batch scan runs at kernel rate.  The handle
    is bound to the tables' packing (chunk length, class map); pass
    it only with the documents it was built from."""

    __slots__ = ("K", "spans", "prepared", "nbytes", "_key",
                 "b_multiple", "full", "aux")

    def __init__(self, K, spans, prepared, nbytes, key,
                 b_multiple=1):
        self.K = K
        self.spans = spans
        self.prepared = prepared
        self.nbytes = nbytes
        self._key = key
        self.b_multiple = b_multiple
        # optional second prep under the FULL machine's layout (the
        # fused batch path needs both; Scanner.prepare_many fills it)
        self.full = None
        # device-resident per-chunk doc metadata for the fused batch
        # summary (built lazily by _fused_batch_dispatch; reused
        # across calls so the ~C-int upload is paid once)
        self.aux = None


def _pack_key(tables):
    return (type(tables).__name__, tables.ncls,
            getattr(tables, "bits", 4), getattr(tables, "bpu", 1),
            tables.warmup)


def batch_prepare(tables, docs, chunk_len=DEFAULT_K, b_multiple=1):
    """Pack the document set into one chunk stream and upload it.
    spans[d] = (chunk_ofs, nchunks, len(doc)); b_multiple pads the
    block count so the batch shards evenly over a mesh."""
    K = effective_chunk(tables, chunk_len)
    pad = bytes([_pad_byte(tables)])
    spans = []
    parts = []
    c = 0
    nbytes = 0
    for d in docs:
        if not isinstance(d, (bytes, bytearray)):
            d = bytes(d)
        n = len(d)
        nbytes += n
        cd = max(1, -(-n // K))
        spans.append((c, cd, n))
        parts.append(d)
        if cd * K > n:
            parts.append(pad * (cd * K - n))
        c += cd
    buf = b"".join(parts)
    prepared = _prepare(tables, buf, K, b_multiple=b_multiple)
    assert prepared[2] == K and prepared[1] == c, (prepared[1:4], K, c)
    return PreparedBatch(K, spans, prepared, nbytes,
                         _pack_key(tables), b_multiple)


def _batch_dispatch(tables, docs, chunk_len, count, prepared=None,
                    mesh=None, esc=None):
    """Pack docs into one chunk stream (or reuse a PreparedBatch),
    run ONE kernel pass — shard_mapped over the mesh's block dim when
    mesh is given — return (K, spans, phi, cnt_or_many, swarm) with
    spans[d] = (chunk_ofs, nchunks, len(doc)).  ``esc`` threads the
    core tier's ESC sink premult through to the kernel."""
    bm = mesh.devices.size if mesh is not None else 1
    if (prepared is None or prepared._key != _pack_key(tables)
            or prepared.b_multiple % bm != 0
            # a handle built from DIFFERENT documents would decode
            # garbage silently — re-prep on any length mismatch (the
            # cheap check; byte-level identity is the caller's side
            # of the contract)
            or len(prepared.spans) != len(docs)
            or any(s[2] != len(d)
                   for s, d in zip(prepared.spans, docs))):
        prepared = batch_prepare(tables, docs, chunk_len,
                                 b_multiple=bm)
    K, spans = prepared.K, prepared.spans
    data, C, Kp, J, B = prepared.prepared
    W = tables.warmup
    topm0 = getattr(tables, "to_premult", None)
    seed = topm0(0) if topm0 else 0
    s0p, j0p = _batch_entry_planes(jnp.int32(W),
                                   [s for s, _, _ in spans],
                                   jnp.int32(seed), B=B)
    _, packed = tables._scan(
        data if isinstance(data, jax.Array) else jnp.asarray(data),
        s0p, j0p, jnp.int32(C), jnp.int32(-1), J, W, COUNT=count,
        mesh=mesh, axis="data" if mesh is not None else None,
        esc=esc)
    # the whole-buffer summary is meaningless here (the chain "breaks"
    # at every document boundary by construction); the per-document
    # fold below reads the per-chunk planes directly
    phi, aux, swarm = _unpack(packed, C)
    return K, spans, phi, aux, swarm


class _DocFold:
    """Vectorized per-document repair fold over the per-chunk planes
    — the batch analogue of pallas_core._Fold.  The scalar per-chunk
    walk is O(total chunks) Python (a 256-doc x 1 MB set is 131,072
    iterations); here the chain
    links are precomputed with numpy and each maximal TRUSTED RUN
    resolves in O(1), so Python work scales with docs + breaks +
    repairs.

    ok[c] marks an intrinsically trustable chunk (full-length, plus
    any caller condition like phi != ESC; fire-free when quiet);
    cont[c] says the run may extend to c+1 (c+1 trustable, its
    speculated entry matches c's exit, and c+1 does not start a new
    document — document starts always begin a fresh run at the
    seed)."""

    __slots__ = ("phi", "cnt", "swarm", "ok", "ok_raw", "breaks",
                 "cum")

    def __init__(self, phi, cnt, swarm, spans, K, quiet=False,
                 ok_extra=None):
        C = len(phi)
        self.phi, self.cnt, self.swarm = phi, cnt, swarm
        full = np.zeros(C, dtype=bool)
        doc_start = np.zeros(C, dtype=bool)
        for c0, cd, n in spans:
            full[c0:c0 + cd] = True
            if cd * K > n:
                full[c0 + cd - 1] = False   # ragged tail: never trust
            doc_start[c0] = True
        ok = full
        if ok_extra is not None:
            ok = ok & ok_extra
        # ok_raw ignores the quiet (fire-free) condition: scan folds
        # use it to tell a trusted-but-FIRING chunk (exact native pin
        # from a validated entry — not a repair) from a real miss
        self.ok_raw = ok
        if quiet:
            ok = ok & (cnt == 0)
        self.ok = ok
        cont = np.zeros(C, dtype=bool)
        if C > 1:
            cont[:C - 1] = (ok[1:] & (swarm[1:] == phi[:C - 1])
                            & ~doc_start[1:])
        self.breaks = np.flatnonzero(~cont)   # C-1 is always a break
        self.cum = np.cumsum(cnt.astype(np.int64))

    def run_end(self, c):
        """Last chunk b >= c of the maximal trusted run from c (never
        crosses a document boundary: doc starts break cont)."""
        i = np.searchsorted(self.breaks, c)
        return int(self.breaks[i])

    def run_count(self, c, b):
        lo = self.cum[c - 1] if c else 0
        return int(self.cum[b] - lo)


def spec_count_many(tables, docs, chunk_len=DEFAULT_K,
                    prepared=None, mesh=None):
    """Per-document match-boundary counts (boundaries 0..n_d-1; the
    EOF boundary is the caller's, per document).  Returns (counts,
    final_states, nat_chunks, total_chunks) — nat_chunks is the
    number of chunks that needed a native re-walk (ragged tails +
    speculation misses), for observability."""
    from ..native import NativeDfa
    K, spans, phi, cnt, swarm = _batch_dispatch(tables, docs,
                                                chunk_len, True,
                                                prepared, mesh)
    ncls = tables.ncls
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)
    native = NativeDfa(tables.dfa)
    fold = _DocFold(phi, cnt, swarm, spans, K)
    counts = []
    finals = []
    nat = 0
    for (c0, cd, n), doc in zip(spans, docs):
        raw = doc if isinstance(doc, (bytes, bytearray)) else bytes(doc)
        e = topm(0)                 # seed, premultiplied
        total = 0
        c = c0
        end = c0 + cd
        while c < end:
            if fold.ok[c] and int(swarm[c]) == e:
                b = fold.run_end(c)     # trusted run [c..b], in-doc
                total += fold.run_count(c, b)
                e = int(phi[b])
                c = b + 1
                continue
            lo = (c - c0) * K
            hi = min(lo + K, n)
            k, st = native.count(bytes(raw[lo:hi]), frpm(e))
            total += k
            e = topm(st)
            nat += 1
            c += 1
        counts.append(total)
        finals.append(frpm(e))
    return counts, finals, nat, len(phi)


def spec_scan_many(tables, docs, chunk_len=DEFAULT_K,
                   prepared=None, mesh=None):
    """Per-document first-match scan.  Returns (results, nat_chunks,
    total_chunks); results[d] = (state_at_boundary, boundary) for a
    match at boundaries 0..n_d-1, else (final_state, -1) — EOF
    acceptance is the caller's (tables.match_eof), same contract as
    spec_scan_bytes."""
    from ..native import NativeDfa
    K, spans, phi, many, swarm = _batch_dispatch(tables, docs,
                                                 chunk_len, False,
                                                 prepared, mesh)
    ncls = tables.ncls
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)
    native = NativeDfa(tables.dfa)
    fold = _DocFold(phi, many, swarm, spans, K, quiet=True)
    results = []
    nat = 0
    for (c0, cd, n), doc in zip(spans, docs):
        raw = doc if isinstance(doc, (bytes, bytearray)) else bytes(doc)
        e = topm(0)
        hit = None
        c = c0
        end = c0 + cd
        while c < end:
            if fold.ok[c] and int(swarm[c]) == e:
                b = fold.run_end(c)     # fire-free trusted run
                e = int(phi[b])
                c = b + 1
                continue
            lo = (c - c0) * K
            hi = min(lo + K, n)
            # fired or untrusted: one native scan pins it exactly
            f, st = native.scan_first(bytes(raw[lo:hi]), frpm(e))
            if not (fold.ok_raw[c] and int(swarm[c]) == e):
                nat += 1
            if f >= 0:
                hit = (st, lo + f)
                break
            e = topm(st)
            c += 1
        results.append(hit if hit is not None else (frpm(e), -1))
    return results, nat, len(phi)


def _fused_batch_dispatch(ct, full_tables, docs, chunk_len,
                          prepared_core, prepared_full):
    """Setup + dispatch for the FUSED batched scan (the two-phase
    count/scan discipline applied to the document stream): both batch
    preps aligned on one chunk length, phase-1 entry planes with the
    warmup frozen at document starts, phase-2 j0 plane likewise (a
    document-start redo must not warm up over the previous document's
    tail).  Returns None when the shapes disqualify the fused path
    (the caller falls back to the legacy core/spec batch paths)."""
    from .pallas_big import SpecTablesBig
    from .pallas_scan import SpecTables, SpecTablesWide
    from .pallas_core import (fused_chunk, _tier_statics,
                              _fused_batch, FUSED_CAP)
    from .scan_kernel import implementation
    inner = ct.inner
    if not isinstance(inner, (SpecTables, SpecTablesWide)) \
            or not isinstance(full_tables, (SpecTables,
                                            SpecTablesWide,
                                            SpecTablesBig)):
        return None
    if getattr(inner, "bpu", 1) != 1 \
            or getattr(full_tables, "bpu", 1) != 1:
        return None
    K = fused_chunk(inner, full_tables, chunk_len)
    if K is None:
        return None

    def prep(tables, prepared):
        if (prepared is None or prepared._key != _pack_key(tables)
                or prepared.K != K
                or len(prepared.spans) != len(docs)
                or any(s[2] != len(d)
                       for s, d in zip(prepared.spans, docs))):
            prepared = batch_prepare(tables, docs, K)
        return prepared

    pc = prep(inner, prepared_core)
    pf = prep(full_tables, prepared_full)
    spans = pc.spans
    assert pf.spans == spans, "batch preps disagree on spans"
    core_data, C, Kp, J1, B1 = pc.prepared
    full_data, Cf, Kf, J2, Bf = pf.prepared
    assert (C, Kp) == (Cf, Kf) == (C, K)

    w1, c1, b1 = _tier_statics(inner)
    w2, c2, b2_ = _tier_statics(full_tables)
    h2f_dev = getattr(ct, "_h2f_dev", None)
    if h2f_dev is None:
        h2f = np.full(ct.H + 1, -1, dtype=np.int32)
        h2f[:ct.H] = np.asarray(ct.hot2full[:ct.H], dtype=np.int32)
        h2f_dev = jnp.asarray(h2f)
        ct._h2f_dev = h2f_dev
    blk = GROUPS * 1024
    cap = min(FUSED_CAP, B1 * blk)
    cap = max(blk, -(-cap // blk) * blk)

    starts = [s for s, _, _ in spans]
    seed_c = jnp.int32(0)     # core seed premult is 0 by construction
    s01, j01 = _batch_entry_planes(jnp.int32(w1), starts, seed_c,
                                   B=B1)
    _, j02p = _batch_entry_planes(jnp.int32(w2), starts, seed_c,
                                  B=B1)
    fv1, fv2 = inner.table, full_tables.table

    # per-chunk doc metadata for the DEVICE-side per-document fold
    # (device-resident, cached on the core prep handle: the ~C-int
    # upload is paid once per prepared set, and the common-case
    # readback is the tiny summary instead of megabytes of planes)
    ndocs = len(docs)
    if pc.aux is None:
        Cp = B1 * GROUPS * 1024
        doc_id = np.full(Cp, ndocs, np.int32)
        fullv = np.zeros(Cp, np.int32)
        startv = np.zeros(Cp, np.int32)
        last_full = np.full(ndocs, -1, np.int32)
        for i, (c0, cd, nd) in enumerate(spans):
            doc_id[c0:c0 + cd] = i
            fullv[c0:c0 + cd] = 1
            fcd = cd - 1 if cd * K > nd else cd
            if fcd < cd:
                fullv[c0 + cd - 1] = 0
            startv[c0] = 1
            if fcd > 0:
                last_full[i] = c0 + fcd - 1
        pc.aux = (jnp.asarray(doc_id), jnp.asarray(fullv),
                  jnp.asarray(startv), jnp.asarray(last_full))
    doc_id_d, fullv_d, startv_d, last_full_d = pc.aux

    summary, merged, packed, flags = _fused_batch(
        core_data if isinstance(core_data, jax.Array)
        else jnp.asarray(core_data),
        full_data if isinstance(full_data, jax.Array)
        else jnp.asarray(full_data),
        s01, j01, j02p.reshape(-1), fv1, fv2, h2f_dev, np.int32(C),
        doc_id_d, fullv_d, startv_d, last_full_d,
        K=K, W1=w1, CPW1=c1, BITS1=b1, W2=w2, CPW2=c2, BITS2=b2_,
        CAP=cap, NCLS_C=inner.ncls, NCLS_F=full_tables.ncls,
        ESC=ct.esc_premult, IMPL=implementation(), NDOCS=ndocs)
    summ = np.asarray(summary).astype(np.int64)
    return {"K": K, "spans": spans, "C": C,
            "all_ok": bool(summ[0]), "n_esc": int(summ[1]),
            "overflow": int(summ[1]) > cap,
            "dcounts": summ[2:2 + ndocs],
            "dfinals": summ[2 + ndocs:],
            # plane handles stay LAZY: only the repair paths pull them
            "merged_dev": merged, "packed_dev": packed}


def core_count_many_fused(ct, full_tables, docs, chunk_len=DEFAULT_K,
                          prepared_core=None, prepared_full=None):
    """Per-document counts via the FUSED two-phase batch dispatch:
    escaped chunks are redone by the FULL machine's kernel on device
    (one dispatch for the whole set) instead of one native host walk
    each — the batched analogue of core_count_fused, for the serving
    shape (many documents, big machine).  Contract of
    core_count_many; returns None when the shapes disqualify the
    fused path."""
    d = _fused_batch_dispatch(ct, full_tables, docs, chunk_len,
                              prepared_core, prepared_full)
    if d is None:
        return None
    K, spans = d["K"], d["spans"]
    native = ct.native
    ncls_f = full_tables.ncls
    counts, finals, nat = [], [], 0
    if d["all_ok"] and sum(s[2] for s in spans) < 2 ** 31:
        # every document's full-chunk chain validated ON DEVICE: the
        # readback was the ~2*ndocs-int summary, no planes.  Only
        # ragged tails finish on host, from each doc's device exit.
        dcounts, dfinals = d["dcounts"], d["dfinals"]
        for i, ((c0, cd, nd), doc) in enumerate(zip(spans, docs)):
            raw = doc if isinstance(doc, (bytes, bytearray)) \
                else bytes(doc)
            fcd = cd - 1 if cd * K > nd else cd
            if fcd > 0:
                total = int(dcounts[i])
                e_full = int(dfinals[i]) // ncls_f
            else:
                total = 0
                e_full = 0
            lo = fcd * K
            if lo < nd:
                k, st = native.count(bytes(raw[lo:nd]), e_full)
                total += k
                e_full = st
                nat += 1
            counts.append(total)
            finals.append(e_full)
        return counts, finals, nat, d["C"]
    if d["overflow"]:
        # more escapes than the device redo cap: legacy fold over the
        # CORE-space planes (core_count_many's discipline)
        phi, cnt, swarm = np.asarray(
            d["packed_dev"]).astype(np.int64)
        esc = ct.esc_premult
        fold = _DocFold(phi, cnt, swarm, spans, K,
                        ok_extra=(phi != esc))
        for (c0, cd, n), doc in zip(spans, docs):
            raw = doc if isinstance(doc, (bytes, bytearray)) \
                else bytes(doc)
            e_full = 0
            total = 0
            c = c0
            end = c0 + cd
            while c < end:
                cp = ct.to_core_premult(e_full)
                if cp >= 0 and fold.ok[c] and int(swarm[c]) == cp:
                    b = fold.run_end(c)
                    total += fold.run_count(c, b)
                    e_full = ct.to_full(int(fold.phi[b]))
                    c = b + 1
                    continue
                lo = (c - c0) * K
                hi = min(lo + K, n)
                k, st = native.count(bytes(raw[lo:hi]), e_full)
                total += k
                e_full = st
                nat += 1
                c += 1
            counts.append(total)
            finals.append(e_full)
        return counts, finals, nat, d["C"]
    phi_m, fm_m, swarm_m = np.asarray(
        d["merged_dev"]).astype(np.int64)
    fold = _DocFold(phi_m, fm_m, swarm_m, spans, K,
                    ok_extra=(phi_m >= 0))
    for (c0, cd, n), doc in zip(spans, docs):
        raw = doc if isinstance(doc, (bytes, bytearray)) \
            else bytes(doc)
        e = 0                       # full premult; seed premult is 0
        total = 0
        c = c0
        end = c0 + cd
        while c < end:
            if e >= 0 and fold.ok[c] and int(swarm_m[c]) == e:
                b = fold.run_end(c)
                total += fold.run_count(c, b)
                e = int(phi_m[b])
                c = b + 1
                continue
            lo = (c - c0) * K
            hi = min(lo + K, n)
            k, st = native.count(bytes(raw[lo:hi]),
                                 max(e, 0) // ncls_f)
            total += k
            e = st * ncls_f
            nat += 1
            c += 1
        counts.append(total)
        finals.append(max(e, 0) // ncls_f)
    return counts, finals, nat, d["C"]


def core_scan_many_fused(ct, full_tables, docs, chunk_len=DEFAULT_K,
                         prepared_core=None, prepared_full=None):
    """Per-document first-match scan via the fused batch dispatch;
    contract of core_scan_many (FULL-machine states).  Returns None
    when the shapes disqualify the fused path."""
    d = _fused_batch_dispatch(ct, full_tables, docs, chunk_len,
                              prepared_core, prepared_full)
    if d is None:
        return None
    K, spans = d["K"], d["spans"]
    native = ct.native
    ncls_f = full_tables.ncls
    results, nat = [], 0
    if d["all_ok"] and sum(s[2] for s in spans) < 2 ** 31:
        # device-validated: fire-free documents advance straight to
        # their tail; a firing document resolves with ONE early-exit
        # native scan from its start (exact; sparse in the serving
        # shape — finditer_many uses this to filter match-free docs)
        dcounts, dfinals = d["dcounts"], d["dfinals"]
        for i, ((c0, cd, nd), doc) in enumerate(zip(spans, docs)):
            raw = doc if isinstance(doc, (bytes, bytearray)) \
                else bytes(doc)
            fcd = cd - 1 if cd * K > nd else cd
            if int(dcounts[i]) > 0:
                f, st = native.scan_first(bytes(raw[:nd]), 0)
                results.append((st, f))
                continue
            e_full = int(dfinals[i]) // ncls_f if fcd > 0 else 0
            lo = fcd * K
            hit = None
            if lo < nd:
                f, st = native.scan_first(bytes(raw[lo:nd]), e_full)
                nat += 1
                if f >= 0:
                    hit = (st, lo + f)
                else:
                    e_full = st
            results.append(hit if hit is not None else (e_full, -1))
        return results, nat, d["C"]
    if d["overflow"]:
        phi, many, swarm = np.asarray(
            d["packed_dev"]).astype(np.int64)
        esc = ct.esc_premult
        fold = _DocFold(phi, many, swarm, spans, K, quiet=True,
                        ok_extra=(phi != esc))
        for (c0, cd, n), doc in zip(spans, docs):
            raw = doc if isinstance(doc, (bytes, bytearray)) \
                else bytes(doc)
            e_full = 0
            hit = None
            c = c0
            end = c0 + cd
            while c < end:
                cp = ct.to_core_premult(e_full)
                if cp >= 0 and fold.ok[c] and int(swarm[c]) == cp:
                    b = fold.run_end(c)
                    e_full = ct.to_full(int(fold.phi[b]))
                    c = b + 1
                    continue
                lo = (c - c0) * K
                hi = min(lo + K, n)
                f, st = native.scan_first(bytes(raw[lo:hi]), e_full)
                if not (cp >= 0 and fold.ok_raw[c]
                        and int(swarm[c]) == cp):
                    nat += 1
                if f >= 0:
                    hit = (st, lo + f)
                    break
                e_full = st
                c += 1
            results.append(hit if hit is not None else (e_full, -1))
        return results, nat, d["C"]
    phi_m, fm_m, swarm_m = np.asarray(
        d["merged_dev"]).astype(np.int64)
    fold = _DocFold(phi_m, fm_m, swarm_m, spans, K, quiet=True,
                    ok_extra=(phi_m >= 0))
    for (c0, cd, n), doc in zip(spans, docs):
        raw = doc if isinstance(doc, (bytes, bytearray)) \
            else bytes(doc)
        e = 0
        hit = None
        c = c0
        end = c0 + cd
        while c < end:
            if e >= 0 and fold.ok[c] and int(swarm_m[c]) == e:
                b = fold.run_end(c)
                e = int(phi_m[b])
                c = b + 1
                continue
            lo = (c - c0) * K
            hi = min(lo + K, n)
            f, st = native.scan_first(bytes(raw[lo:hi]),
                                      max(e, 0) // ncls_f)
            if not (e >= 0 and fold.ok_raw[c]
                    and int(swarm_m[c]) == e):
                nat += 1
            if f >= 0:
                hit = (st, lo + f)
                break
            e = st * ncls_f
            c += 1
        results.append(hit if hit is not None
                       else (max(e, 0) // ncls_f, -1))
    return results, nat, d["C"]


def core_count_many(ct, docs, chunk_len=DEFAULT_K, prepared=None,
                    mesh=None):
    """Per-document counts on the ADAPTIVE CORE tier: one narrow/pair
    kernel dispatch over the sampled hot-core machine serves the whole
    document set — the batched analogue of core_count_bytes for
    automata past the static-tier budget (where spec_count_many would
    bottom out at the big tier or have no tier at all).

    Exactness is the core tier's usual contract applied per document:
    a chunk is trusted only when it is full-length, its speculated
    entry matches the chained entry, and it never left the core
    (phi != ESC); everything else — escapes, ragged tails, cold
    entries outside the hot set — re-walks natively on the FULL
    machine (ct.native).  Returns (counts, final_full_states,
    nat_chunks, total_chunks)."""
    K, spans, phi, cnt, swarm = _batch_dispatch(
        ct.inner, docs, chunk_len, True, prepared, mesh,
        esc=ct.esc_premult)
    native = ct.native
    esc = ct.esc_premult
    fold = _DocFold(phi, cnt, swarm, spans, K, ok_extra=(phi != esc))
    counts, finals, nat = [], [], 0
    for (c0, cd, n), doc in zip(spans, docs):
        raw = doc if isinstance(doc, (bytes, bytearray)) else bytes(doc)
        e_full = 0                   # every document starts at the seed
        total = 0
        c = c0
        end = c0 + cd
        while c < end:
            cp = ct.to_core_premult(e_full)
            if cp >= 0 and fold.ok[c] and int(swarm[c]) == cp:
                b = fold.run_end(c)
                total += fold.run_count(c, b)
                e_full = ct.to_full(int(fold.phi[b]))
                c = b + 1
                continue
            lo = (c - c0) * K
            hi = min(lo + K, n)
            k, st = native.count(bytes(raw[lo:hi]), e_full)
            total += k
            e_full = st
            nat += 1
            c += 1
        counts.append(total)
        finals.append(e_full)
    return counts, finals, nat, len(phi)


def core_scan_many(ct, docs, chunk_len=DEFAULT_K, prepared=None,
                   mesh=None):
    """Per-document first-match scan on the adaptive core tier; the
    contract of spec_scan_many with FULL-machine states: results[d] =
    (full_state_at_boundary, boundary) or (final_full_state, -1)."""
    K, spans, phi, many, swarm = _batch_dispatch(
        ct.inner, docs, chunk_len, False, prepared, mesh,
        esc=ct.esc_premult)
    native = ct.native
    esc = ct.esc_premult
    fold = _DocFold(phi, many, swarm, spans, K, quiet=True,
                    ok_extra=(phi != esc))
    results, nat = [], 0
    for (c0, cd, n), doc in zip(spans, docs):
        raw = doc if isinstance(doc, (bytes, bytearray)) else bytes(doc)
        e_full = 0
        hit = None
        c = c0
        end = c0 + cd
        while c < end:
            cp = ct.to_core_premult(e_full)
            if cp >= 0 and fold.ok[c] and int(swarm[c]) == cp:
                b = fold.run_end(c)
                e_full = ct.to_full(int(fold.phi[b]))
                c = b + 1
                continue
            lo = (c - c0) * K
            hi = min(lo + K, n)
            f, st = native.scan_first(bytes(raw[lo:hi]), e_full)
            if not (cp >= 0 and fold.ok_raw[c]
                    and int(swarm[c]) == cp):
                nat += 1
            if f >= 0:
                hit = (st, lo + f)
                break
            e_full = st
            c += 1
        results.append(hit if hit is not None else (e_full, -1))
    return results, nat, len(phi)
