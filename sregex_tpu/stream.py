"""High-level streaming scan API.

The reference's signature feature is resumable matching over unbounded
chunked streams (sre_vm_pike_exec's SRE_AGAIN protocol,
sre_vm_pike.c:148-689).  This module provides that protocol over the
DFA engines, picking the execution backend per chunk size:

  - small chunks: the native C++ scanner (sregex_tpu/native.py), or
    the pure-Python table walk as a fallback;
  - large chunks: the device scan (ops/scan.py) — per-chunk transfer
    functions composed associatively, entry state applied at the end;
  - multi-device: parallel/sharded_scan.py with the same carry.

The resumable carry is exactly {state, processed_bytes} — the dense
analogue of the Pike/Thompson ctx (SURVEY.md §3.3: everything that
crosses a chunk boundary; assertions' seen_word/seen_newline are
folded into the DFA state by construction, dfa.py).

For full leftmost-first spans and captures, Scanner.find() delegates
to the Pike VM on a bounded window once the DFA has located a match
end — the DFA is the filter, Pike is the resolver.
"""

import time

import numpy as np

from .consts import SRE_OK, SRE_AGAIN, SRE_DECLINED, SRE_ERROR, sre_isword
from .dfa import build_dfa, DfaTooLarge
from .diag import ScanStats, degraded
from .pike_vm import PikeCtx


def _build_spec_tables(dfa):
    """Device tier chain, fastest-first: narrow pair-step (half the
    dependent lookups of byte-narrow on eligible automata;
    SREGEX_PAIR=0 disables), then narrow / wide / affine / big byte
    tables.  None when no tier accepts the automaton."""
    import functools
    import os
    from .ops.pallas_scan import SpecTables, SpecTablesWide
    from .ops.pallas_big import SpecTablesBig
    from .ops.pallas_affine import SpecTablesAffine
    chain = []
    if os.environ.get("SREGEX_PAIR") != "0":
        from .ops.pallas_pair import SpecTablesPair
        chain.append(functools.partial(SpecTablesPair,
                                       narrow_only=True))
    chain.append(SpecTables)
    if os.environ.get("SREGEX_AFFINE") != "0":
        # piecewise-affine chains: a tiny piece count (few compares +
        # one small-table gather) goes before the wide table; a larger
        # P still goes before the big table
        chain.append(functools.partial(SpecTablesAffine,
                                       max_pieces=6))
        chain += [SpecTablesWide, SpecTablesAffine, SpecTablesBig]
    else:
        chain += [SpecTablesWide, SpecTablesBig]
    for cls in chain:
        try:
            return cls(dfa)
        except ValueError:
            continue
        except Exception as e:
            # device backend unavailable/broken at runtime: degrade
            # to the host engines rather than failing the scan API —
            # but loudly (warn once; SREGEX_STRICT_DEVICE=1 raises):
            # a broken device stack silently serving host-rate scans
            # is an outage in production
            name = getattr(cls, "__name__", None) or getattr(
                getattr(cls, "func", None), "__name__", str(cls))
            degraded("spec-tier",
                     f"device tier construction failed "
                     f"({name}: {e!r})")
            return None
    return None


def _core_requirement(spec):
    """Adaptive-core eligibility for a static kernel tier: None = the
    core tier must stay out (the static chain already found a fast
    1-gather tier, or SREGEX_CORE=0); otherwise the value is the
    ``require_fast`` flag for CoreTables (True over a static wide
    tier: only a pair/narrow core can beat what we already have)."""
    import os
    if os.environ.get("SREGEX_CORE") == "0":
        return None
    from .ops.pallas_scan import SpecTablesWide
    from .ops.pallas_big import SpecTablesBig
    if spec is None or isinstance(spec, SpecTablesBig):
        return False
    if isinstance(spec, SpecTablesWide) and spec.rows > 4:
        # small wide tables stay static (the core tier adds a
        # per-scan plane readback); only large ones are worth the
        # upgrade.  The band edges come from measurements on an
        # earlier device; their re-measurement on the GPU is open
        return True
    return None


def _core_band(spec):
    """Core-vs-static decision band for the Scanner: 'static' = the
    core tier stays out (small tables), 'core' = the core tier goes
    first (large wide tables, the big tier), 'ab' = the ambiguous
    mid-band — measure both arms on the first large scan and stick
    with the winner.  The band edges come from measurements on an
    earlier device; their re-measurement on the GPU is open."""
    from .ops.pallas_scan import SpecTablesWide
    from .ops.pallas_big import SpecTablesBig
    if spec is None or isinstance(spec, SpecTablesBig):
        return "core"
    if isinstance(spec, SpecTablesWide):
        if spec.rows <= 2:
            return "static"
        return "core" if spec.rows > 16 else "ab"
    return "static"


def _try_device(owner, key, attr, thunk):
    """Run one device-kernel dispatch; on ANY failure (compile
    error, XlaRuntimeError, a kernel rejected at first use) degrade
    loudly (diag.degraded: warn once, or raise under
    SREGEX_STRICT_DEVICE=1), decline the failing tier for ``owner``'s
    lifetime, and return None so the caller falls through to the next
    tier or the host engines.

    Tier CONSTRUCTION failures were already guarded
    (_build_spec_tables); this closes the other half (VERDICT r3
    #1b): a kernel that only explodes when it first compiles/runs —
    an out-of-memory compile, say — must not crash the scan API.  The
    reference never crashes on machine shape (sre_vm_pike.c:165-168
    returns SRE_ERROR); neither may we."""
    try:
        return thunk()
    except Exception as e:
        degraded(key, f"device dispatch failed "
                      f"({type(e).__name__}: {e})")
        if attr in ("_spec", "_rev_spec"):
            setattr(owner, attr, None)
        elif attr == "_phi":
            owner._phi = False
            owner._phi_active = False
        elif attr:
            setattr(owner, attr, False)
        return None


class StreamScanner:
    """Resumable boolean scanner over one stream (Thompson-equivalent
    semantics: reports the earliest boundary where any match ends)."""

    DEVICE_THRESHOLD = 1 << 20  # chunks >= 1 MiB go to the device
    CORE_SAMPLE = 256 << 10     # hot-core sample bytes (chunk head)

    def __init__(self, dfa, use_device=False, device_tables=None):
        self.dfa = dfa
        self.state = 0
        self.processed_bytes = 0
        self.eof = False
        # regex id of the match that produced SRE_OK (multi-regex
        # programs; 0 for single-regex), -1 before any match
        self.matched_regex = -1
        self.use_device = use_device
        self._tables = device_tables
        self._coret = None   # adaptive core tier; False = declined
        from .native import NativeDfa
        self._native = NativeDfa(dfa)

    def _device_tables(self):
        if self._tables is None:
            self._tables = _build_spec_tables(self.dfa)
            if self._tables is None:
                self._tables = False
        return self._tables

    def _core_tables(self, chunk):
        """Adaptive hot-core tier for streamed chunks whose static
        tier chain fell short of the fast kernels (see Scanner).
        Sampled once from the first large chunk's head; exactness
        never depends on the sample (escape repair)."""
        if self._coret is None:
            self._coret = False
            req = _core_requirement(self._device_tables() or None)
            if req is not None:
                try:
                    from .ops.pallas_core import CoreTables
                    self._coret = CoreTables(
                        self.dfa, bytes(chunk[:self.CORE_SAMPLE]),
                        require_fast=req)
                except ValueError:
                    self._coret = False
        return self._coret or None

    def exec(self, chunk, eof=False):
        """Feed one chunk.  Returns (rc, match_end_abs):
        rc = SRE_OK (match; match_end_abs = absolute stream offset of
        the earliest match end), SRE_AGAIN (feed more), SRE_DECLINED
        (stream ended, no match), SRE_ERROR (stream already finished).
        On SRE_OK, ``self.matched_regex`` holds the id of the matched
        regex (multi-regex programs; 0 for single-regex).

        After SRE_OK or SRE_DECLINED the stream is finished: further
        exec() calls return SRE_ERROR (the reference's misuse contract,
        sre_vm_pike.c:165-168).
        """
        if self.eof:
            return SRE_ERROR, -1
        if chunk is None:
            chunk = b""

        if len(chunk):
            first = None
            if self.use_device and len(chunk) >= self.DEVICE_THRESHOLD:
                ct = self._core_tables(chunk)
                if ct is not None \
                        and ct.to_core_premult(self.state) >= 0:
                    from .ops.pallas_core import core_scan_bytes
                    state, first = core_scan_bytes(
                        ct, chunk, entry_state=self.state)
                else:
                    tables = self._device_tables()
                    if tables:
                        from .ops.pallas_scan import spec_scan_bytes
                        state, first = spec_scan_bytes(
                            tables, chunk, entry_state=self.state)
            if first is None:
                first, state = self._native.scan_first(chunk, self.state)
            if first >= 0:
                # post-match contract: the scanner is FINISHED.  Like a
                # stream whose ctx already returned a final result,
                # further exec() calls are misuse and return SRE_ERROR
                # (sre_vm_pike.c:165-168).  Identical on both backends.
                # Both backends return the state AT the boundary, so
                # the matched regex id is one table lookup.
                self.eof = True
                self.matched_regex = self.dfa.id_at(state, chunk[first])
                return SRE_OK, self.processed_bytes + first
            self.state = state
            self.processed_bytes += len(chunk)

        if eof:
            self.eof = True
            rid = int(self.dfa.match_eof_id[self.state])
            if rid >= 0:
                self.matched_regex = rid
                return SRE_OK, self.processed_bytes
            return SRE_DECLINED, -1
        return SRE_AGAIN, -1


class PreparedCorpus:
    """Device-resident packed corpus, reusable across scans (the
    production serving shape: prepare once when the shard arrives,
    then every match/count/scan over it skips the class-map/pack/
    upload pre-pass — roughly 3x on repeat scans).  Obtained from
    Scanner.prepare(data); pass back via the ``prepared=`` keyword.
    Prep layouts differ per kernel tier, so entries are cached per
    tables object (a drift-triggered re-core automatically re-preps
    under the new tables)."""

    def __init__(self, data, chunk_len=2048):
        self.data = data
        self.chunk_len = chunk_len
        self._by_tables = {}
        self._raw_dev = None

    def _raw(self):
        """Upload the raw bytes ONCE; every per-tables prep pads and
        packs on device from the same device-resident array.  The
        fused two-phase tier needs TWO prep layouts (core + full
        machine) over the same corpus — sharing the raw upload halves
        the cold cost of exactly that shape."""
        if self._raw_dev is None:
            import jax.numpy as jnp
            arr = (self.data if isinstance(self.data, np.ndarray)
                   else np.frombuffer(self.data, dtype=np.uint8))
            self._raw_dev = jnp.asarray(arr)
            self._raw_dev.block_until_ready()
        return self._raw_dev

    def for_tables(self, tables, chunk_len=None):
        """Packed prep for one tables object.  ``chunk_len`` overrides
        the corpus default — the fused two-phase tier aligns its TWO
        preps (core + full machine) on one chunk length, which can
        differ from either tier's own clamp once the warmup ladder
        escalates the full machine (pallas_core.fused_chunk)."""
        ck = self.chunk_len if chunk_len is None else chunk_len
        key = (id(tables), ck)
        p = self._by_tables.get(key)
        if p is None:
            from .ops.pallas_phi import PhiTables, phi_prepare
            if isinstance(tables, PhiTables):
                # φ tiers: own layout (no warmup windows)
                p = phi_prepare(tables, self.data, ck)
            else:
                import os
                from .ops.prep import prepare_auto, DEVICE_PREP_MIN
                knob = os.environ.get("SREGEX_DEVICE_PREP")
                use_dev = (len(self.data) >= DEVICE_PREP_MIN
                           if knob is None else knob == "1")
                src = self._raw() if use_dev else self.data
                p = prepare_auto(tables, src, ck)
            self._by_tables[key] = p
        return p


class Scanner:
    """Whole-corpus convenience API over a compiled pattern set.

    match(data)      -> bool (any match; DFA fast path)
    count(data)      -> number of boundaries where a match ends
    find(data)       -> (regex_id, ovector) of the leftmost-first
                        match per full Pike semantics, or None
    finditer(data)   -> yields successive Pike matches (the re-arm
                        protocol, including empty-match handling)

    match/count/scan accept ``prepared=Scanner.prepare(data)`` to
    reuse the device-resident packed corpus across calls.
    """

    def __init__(self, prog, use_device=False, ast=None, dfa=None,
                 mesh=None):
        self.program = prog
        self.ast = ast
        # device mesh for multi-chip scans (jax.sharding.Mesh);
        # the kernels shard the chunk-block dim across it and the
        # host folds are mesh-agnostic (ops/pallas_scan.py)
        self.mesh = mesh
        if dfa is not None:
            # prebuilt tables (serialize.load_compiled): skip subset
            # construction entirely
            self.dfa = dfa
        else:
            try:
                self.dfa = build_dfa(prog)
            except DfaTooLarge:
                self.dfa = None
        self.use_device = use_device
        self._native = None
        self._tables = None
        self._spec = None
        self._tdfa_spec = None
        if self.dfa is not None:
            from .native import NativeDfa
            self._native = NativeDfa(self.dfa)
            if use_device:
                self._spec = _build_spec_tables(self.dfa)
                try:
                    from .ops.tdfa_scan import TdfaSpecTables
                    self._tdfa_spec = TdfaSpecTables(prog)
                except (DfaTooLarge, ValueError):
                    # too large for the tagged kernel: the multi-pass
                    # paths (and ultimately the host engines) cover it
                    self._tdfa_spec = None
                except Exception as e:
                    # device backend broken at runtime: fall back,
                    # but loudly (SREGEX_STRICT_DEVICE=1 raises)
                    degraded("tdfa-tier",
                             f"tagged-DFA tier construction failed "
                             f"({e!r})")
                    self._tdfa_spec = None
        # adaptive hot-core tier (ops/pallas_core.py): built lazily
        # from a corpus sample when the static chain bottomed out at
        # the big tier (or none); None = untried, False = declined
        self._coret = None
        self._rev_coret = None   # same, for the REVERSE machine
        # native TDFA walker (lazy): resolves finditer/sub matches
        # from tagged-DFA registers at table-walk speed instead of
        # Pike thread simulation (~100x on dense-match corpora)
        self._walker = None
        # reverse automaton (lazy): locates match STARTS by scanning
        # backwards, so find() only simulates the match region
        self._rev = False
        # prefer the C++ Pike engine for capture resolution
        self._pike_nprog = None
        try:
            from .native_pike import NativePikeCtx, NativeProgram
            if NativePikeCtx.available():
                self._pike_nprog = NativeProgram(prog)
        except Exception:
            self._pike_nprog = None

    def _pike_ctx(self):
        """Capture-resolution ctx for the high-level API: EXACT mode,
        i.e. true leftmost-first with the reference's lossy prefilter
        re-seed disabled.  The full-buffer engines keep that quirk
        only for byte-exact CLI conformance; the reference's own
        streaming (splitted) mode agrees with exact mode."""
        if self._pike_nprog is not None:
            from .native_pike import NativePikeCtx
            return NativePikeCtx(self._pike_nprog, exact=True)
        return PikeCtx(self.program, exact=True)

    DEVICE_THRESHOLD = 4 << 20   # below this the host engine wins
    CORE_SAMPLE = 256 << 10      # bytes per hot-core sample slice

    def _core_sample(self, data):
        """Four slices spread over the corpus so the hot-core sample
        sees more than the head's byte distribution."""
        n = len(data)
        w = self.CORE_SAMPLE
        cuts = sorted({0, max(0, n // 3), max(0, 2 * n // 3),
                       max(0, n - w)})
        return b"".join(bytes(data[c:c + w]) for c in cuts)

    def _core_eligible(self, spec):
        """Adaptive-core eligibility: None when the core tier must
        stay out, else the require_fast flag for CoreTables.  The
        Scanner uses the measured decision bands (_core_band): clear
        cases short-circuit, the ambiguous mid-band builds the core
        AND schedules a first-scan A/B (_maybe_tier_ab) whose loser
        is declined for the Scanner's lifetime.  SREGEX_TIER_AB=0
        restores the legacy rows>4 heuristic."""
        import os
        if not self.use_device:
            return None
        if os.environ.get("SREGEX_TIER_AB") == "0" \
                or os.environ.get("SREGEX_CORE") == "0":
            return _core_requirement(spec)
        band = _core_band(spec)
        if band == "static":
            return None
        from .ops.pallas_big import SpecTablesBig
        # over a surviving wide tier only a pair/narrow core helps;
        # over the big tier (or no static tier) anything goes
        return not (spec is None or isinstance(spec, SpecTablesBig))

    def _core_tables(self, data):
        """Adaptive hot-core tier (ops/pallas_core.py): when the
        static tier chain bottomed out at the slow big tier (or no
        device tier fits at all), sample the corpus once and try to
        synthesize a small core machine the narrow kernels can run.
        Exactness never depends on the sample (escaped chunks repair
        natively on the full machine); a poor core only costs speed,
        and CoreTables declines outright when the sampled hot set is
        not coverable.  Cached per Scanner (False = declined)."""
        if self._coret is None:
            self._coret = False
            req = self._core_eligible(self._spec)
            if self.dfa is not None and req is not None:
                try:
                    from .ops.pallas_core import CoreTables
                    self._coret = CoreTables(self.dfa,
                                             self._core_sample(data),
                                             require_fast=req)
                    import os
                    if os.environ.get("SREGEX_TIER_AB") != "0" \
                            and _core_band(self._spec) == "ab":
                        self._ab_pending = True
                except ValueError:
                    self._coret = False
        return self._coret or None

    def _fused_core_tables(self, data):
        """Core tables for the FUSED two-phase count (VERDICT r3 #2):
        escaped chunks are redone by the full machine's kernel inside
        the same dispatch, so WIDE cores are admissible (the legacy
        require_fast gate existed because host-side escape repair
        could never beat an already-wide static tier).  Built only when the static tier is a
        long-chain dense tier the phase-2 redo can reuse.  Cached per
        Scanner (False = declined)."""
        import os
        if getattr(self, "_fusedct", None) is None:
            self._fusedct = False
            if (self.dfa is None or not self.use_device
                    or os.environ.get("SREGEX_FUSED") == "0"
                    or os.environ.get("SREGEX_CORE") == "0"):
                # SREGEX_CORE=0 keeps ALL core tiers out (the fused
                # path is a core tier with device-side repair)
                return None
            from .ops.pallas_scan import SpecTablesWide
            from .ops.pallas_big import SpecTablesBig
            sp = self._spec
            if not ((isinstance(sp, SpecTablesWide) and sp.rows > 4)
                    or isinstance(sp, SpecTablesBig)):
                return None
            try:
                from .ops.pallas_core import (CoreTables,
                                              FUSED_ESCAPE_FRAC)
                self._fusedct = CoreTables(
                    self.dfa, self._core_sample(data),
                    max_escape_frac=FUSED_ESCAPE_FRAC,
                    require_fast=False, no_pair=True,
                    prefer_small=True)
                if os.environ.get("SREGEX_TIER_AB") != "0" \
                        and _core_band(sp) == "ab":
                    self._ab_pending = True
            except ValueError:
                self._fusedct = False
        return self._fusedct or None

    # first-scan core-vs-wide A/B (VERDICT r2 #9): arm bytes cap and
    # the displacement margin (static must beat the already-built
    # core by >10% to win; arms interleave in ONE process and take
    # min-of-2)
    TIER_AB_BYTES = 32 << 20
    TIER_AB_MARGIN = 1.1

    def _maybe_tier_ab(self, data):
        """Mid-band wide tiers: measure core (fused two-phase when
        available, else legacy) vs static on the corpus actually being
        scanned (once per Scanner) and decline the loser.  Both arms
        run a full count over the same slice with value readback; a
        warmup rep per arm absorbs compiles."""
        if not getattr(self, "_ab_pending", False):
            return
        fct = getattr(self, "_fusedct", None)
        ct = fct or self._coret
        if ct in (None, False) or self._spec is None:
            self._ab_pending = False
            return
        if len(data) < self.DEVICE_THRESHOLD:
            return                  # wait for a production-size scan
        self._ab_pending = False
        ab = bytes(data[:self.TIER_AB_BYTES])
        from .ops.pallas_core import core_count_bytes, core_count_fused
        from .ops.pallas_scan import spec_count_bytes
        core_attr = "_fusedct" if fct else "_coret"
        # prepare (pack + upload) once per arm OUTSIDE the timed
        # region: the arms must compare kernels, not the shared
        # host -> device upload
        abp = PreparedCorpus(ab)

        def core_arm():
            if fct:
                r = core_count_fused(
                    fct, self._spec, ab,
                    prepared_core=abp.for_tables(fct.inner),
                    prepared_full=abp.for_tables(self._spec),
                    mesh=self.mesh)
                if r is not None:
                    return r
            return core_count_bytes(ct, ab,
                                    prepared=abp.for_tables(ct.inner),
                                    mesh=self.mesh)

        def static_arm():
            return spec_count_bytes(self._spec, ab,
                                    prepared=abp.for_tables(self._spec),
                                    mesh=self.mesh)

        # the A/B must never blow up the scan it is merely measuring:
        # a failing arm is the loser (declined via _try_device)
        r_s = _try_device(self, "tier-ab-static", "_spec",
                          static_arm)  # untimed: compiles/caches
        if r_s is None:
            return                  # static declined; core serves
        r_c = _try_device(self, "tier-ab-core", core_attr, core_arm)
        if r_c is None:
            return                  # core declined; static serves
        if r_s != r_c:              # exactness guard (never expected)
            degraded("tier-ab", "core/static disagree on the A/B "
                     f"slice ({r_c} vs {r_s}); keeping the core")
            return
        ts, tc = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            static_arm()
            ts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            core_arm()
            tc.append(time.perf_counter() - t0)
        s, c = min(ts), min(tc)
        winner = "static" if s * self.TIER_AB_MARGIN < c else "core"
        self.tier_ab = {
            "bytes": len(ab), "static_s": s, "core_s": c,
            "winner": winner, "core_arm": core_attr,
            "static_gbps": len(ab) / s / 1e9,
            "core_gbps": len(ab) / c / 1e9,
        }
        if winner == "static":
            # measured loser: decline for life
            setattr(self, core_attr, False)

    # re-core on drift: a cached core built from one corpus degrades
    # to repair-heavy scans on differently-distributed data.  Two consecutive completed scans with >25% natively
    # repaired chunks trigger a rebuild from the CURRENT corpus; after
    # MAX_RECORE rebuilds the tier declines for this Scanner (static
    # tier takes over).  Exactness is never at stake — only speed.
    CORE_DRIFT_FRAC = 0.25
    MAX_RECORE = 2

    def _core_note(self, ct, attr="_coret"):
        """Inspect the last completed core scan's repair stats and
        re-core (or decline) on sustained drift."""
        stats = ct.last_repair
        if stats is None:
            return
        nat, C = stats
        strikes = attr + "_strikes"
        if C >= 16 and nat > C * self.CORE_DRIFT_FRAC:
            s = getattr(self, strikes, 0) + 1
            setattr(self, strikes, s)
            if s >= 2:
                setattr(self, strikes, 0)
                r = getattr(self, attr + "_rebuilds", 0) + 1
                setattr(self, attr + "_rebuilds", r)
                # None = rebuild lazily from the next corpus sample;
                # False = decline permanently
                setattr(self, attr,
                        None if r <= self.MAX_RECORE else False)
        else:
            setattr(self, strikes, 0)

    def _note_stats(self, api, tier, nbytes, t0):
        """Record one completed scan (Scanner.stats()).  ``tier`` is
        the tables object that served it (None = host engines); chunk
        and repair counts come from its last_repair convention."""
        rep = getattr(tier, "last_repair", None) \
            if tier is not None else None
        nat, chunks = rep if rep is not None else (0, 0)
        recore = (getattr(self, "_coret_rebuilds", 0)
                  + getattr(self, "_lazy_coret_rebuilds", 0)
                  + getattr(self, "_rev_coret_rebuilds", 0))
        name = type(tier).__name__ if tier is not None else (
            "native" if self.dfa is not None else "lazy")
        self.last_stats = ScanStats(
            api, name, nbytes, chunks=chunks, repaired=nat,
            recore_events=recore,
            warm_events=getattr(self, "_warm_escalations", 0),
            elapsed_ms=(time.perf_counter() - t0) * 1e3)

    def stats(self):
        """Observability: the last completed match/count/scan/stream
        call's ScanStats (which tier served it, kernel chunk count,
        natively repaired chunks, cumulative re-core events, wall
        ms), or None before any scan.  Matched first-match scans
        report chunks=repaired=0 (their fold exits at the match, so
        coverage fractions would be meaningless)."""
        return getattr(self, "last_stats", None)

    # adaptive warmup escalation: a corpus whose run lengths exceed
    # the speculation window repairs natively chunk-by-chunk; for
    # bounded-history automata (counted reps — the state saturates
    # within the max bound) a longer warmup converges on ANY corpus.
    # Two consecutive completed static-tier scans with >25% repaired
    # chunks rebuild the tier with the next window in the ladder
    # (one-time recompile per W; exactness never at stake).
    # 2048 covers every parser-accepted counted-rep product (bounds
    # are < 500 per rep; chained/product histories reach ~1500).  The
    # warmup fraction at W=2048/K=2048 halves walk throughput, but
    # that stays far above the native-repair floor it replaces.
    WARM_LADDER = (128, 512, 2048)

    def _escalate_warmup(self):
        """Advance the static/full tables one rung up WARM_LADDER.
        Returns True on escalation.  Shared by _spec_note and the
        fused path's _fused_note: the escalated tables thread straight
        into the fused phase-2 redo, which certifies with the FULL
        machine's warmup (VERDICT r4 #2)."""
        sp = self._spec
        if sp is None:
            return False
        from .ops.pallas_scan import with_warmup
        nxt = next((w for w in self.WARM_LADDER
                    if w > sp.warmup), None)
        t = with_warmup(sp, nxt) if nxt is not None else None
        if t is None:
            return False
        self._spec = t
        self._warm_escalations = getattr(
            self, "_warm_escalations", 0) + 1
        return True

    def _spec_note(self):
        sp = self._spec
        if sp is None or sp.last_repair is None:
            return
        nat, C = sp.last_repair
        if C >= 16 and nat > C * self.CORE_DRIFT_FRAC:
            s = getattr(self, "_warm_strikes", 0) + 1
            self._warm_strikes = s
            if s >= 2:
                self._warm_strikes = 0
                if not self._escalate_warmup() \
                        and self._phi_tables() is not None:
                    # warmup ladder exhausted (or the tier can't host
                    # a window): never-converging machine — switch to
                    # the exact transfer-composition kernel (zero
                    # speculation, zero repair, corpus-independent)
                    self._phi_active = True
                    self._warm_escalations = getattr(
                        self, "_warm_escalations", 0) + 1
        else:
            self._warm_strikes = 0

    def _fused_note(self, fct):
        """Post-scan bookkeeping for the fused two-phase tier.  Host
        repairs on this path have exactly two causes, recorded by
        core_count_fused/core_scan_fused per scan:

        - "overflow": more escaped chunks than the device redo cap —
          a core-quality problem; the standard drift logic re-cores
          (or declines) the tier.
        - "miss": the merged validation chain broke — a speculative
          warmup failed to converge over a long excursion.  That can
          be the PHASE-2 redo (escaped chunks certify with the FULL
          machine's warmup) or PHASE 1 itself (a chunk that stays
          inside the core but enters mid-excursion: its exit merges
          so it never escapes, yet its swarm cannot certify).
          Re-coring cannot help either case; instead escalate the
          warmup ladder on BOTH machines in lockstep — self._spec
          threads straight into the phase-2 tables, and the core's
          inner tables carry the same window for phase 1 — restoring
          the fused tier's zero-host-repair property for
          long-excursion corpora (VERDICT r4 #2)."""
        cause = getattr(fct, "last_fused_cause", None)
        if cause != "miss":
            self._core_note(fct, "_fusedct")
            return
        rep = fct.last_repair
        if rep is None:
            return
        nat, C = rep
        if C >= 16 and nat > C * self.CORE_DRIFT_FRAC:
            s = getattr(self, "_fused_warm_strikes", 0) + 1
            self._fused_warm_strikes = s
            if s >= 2:
                self._fused_warm_strikes = 0
                self._escalate_warmup()
                sp = self._spec
                if sp is not None and sp.warmup > fct.inner.warmup:
                    from .ops.pallas_scan import with_warmup
                    inner2 = with_warmup(fct.inner, sp.warmup)
                    if inner2 is not None:
                        fct.inner = inner2
                    else:
                        # the core can't host the window the full
                        # machine needs: decline fused — the static
                        # tier (whose own ladder already escalated)
                        # serves instead
                        self._fusedct = False
        else:
            self._fused_warm_strikes = 0

    def _phi_tables(self):
        """Exact φ-composition tier (ops/pallas_phi.py) for S <= 128
        plain-state machines; activated by _spec_note when the warmup
        ladder can't make the corpus converge.  None = ineligible."""
        if getattr(self, "_phi", None) is None:
            self._phi = False
            if self.dfa is not None:
                try:
                    from .ops.pallas_phi import PhiTables, PhiTablesBig
                    try:
                        self._phi = PhiTables(self.dfa)
                    except ValueError:
                        self._phi = PhiTablesBig(self.dfa)
                except ValueError:
                    self._phi = False
        return self._phi or None

    def _rev_fused_core_tables(self, data):
        """Fused-band core tier for the REVERSE machine (round 5):
        when the reverse static tier is a long-chain wide or big
        tier, the finditer start locator's chunk map runs the fused
        two-phase dispatch (escapes redone on device) instead of
        repairing escapes natively per chunk.  Protocol of
        _fused_core_tables; cached per Scanner."""
        import os
        if getattr(self, "_rev_fusedct", None) is None:
            self._rev_fusedct = False
            rev = self._rev_dfa()
            if (rev is None or not self.use_device
                    or os.environ.get("SREGEX_FUSED") == "0"
                    or os.environ.get("SREGEX_CORE") == "0"):
                return None
            from .ops.pallas_scan import SpecTablesWide
            from .ops.pallas_big import SpecTablesBig
            sp = self._rev_spec
            if not ((isinstance(sp, SpecTablesWide) and sp.rows > 4)
                    or isinstance(sp, SpecTablesBig)):
                return None
            try:
                from .ops.pallas_core import (CoreTables,
                                              FUSED_ESCAPE_FRAC)
                self._rev_fusedct = CoreTables(
                    rev.dfa, self._core_sample(data)[::-1],
                    max_escape_frac=FUSED_ESCAPE_FRAC,
                    require_fast=False, no_pair=True,
                    prefer_small=True)
            except ValueError:
                self._rev_fusedct = False
        return self._rev_fusedct or None

    def _rev_core_tables(self, data):
        """Core tier for the REVERSE machine (find()'s start scan and
        the finditer start locator).  Same protocol as _core_tables;
        the sample is taken from the forward corpus and reversed
        (the reverse machine walks the reversed corpus).  Cached per
        Scanner (False = declined)."""
        if getattr(self, "_rev_coret", None) is None:
            self._rev_coret = False
            rev = self._rev_dfa()
            # reverse machine: legacy heuristic only — the first-scan
            # A/B measures the FORWARD machine and its outcome does
            # not transfer (different automaton, different rows)
            req = (_core_requirement(self._rev_spec)
                   if rev is not None and self.use_device else None)
            if req is not None:
                try:
                    from .ops.pallas_core import CoreTables
                    self._rev_coret = CoreTables(
                        rev.dfa, self._core_sample(data)[::-1],
                        require_fast=req)
                except ValueError:
                    self._rev_coret = False
        return self._rev_coret or None

    def prepare(self, data, chunk_len=2048):
        """Pack ``data`` once for device scanning; pass the handle
        back via ``prepared=`` on match/count/scan to skip the
        per-call pre-pass (production serving: prepare when the
        shard arrives, scan many times)."""
        return PreparedCorpus(data, chunk_len)

    def precompile(self, nbytes, sample=b"", chunk_len=2048):
        """Warm every device trace a count() over an ``nbytes``-long
        corpus will need, WITHOUT the corpus: a zero-filled stand-in
        of the same length is allocated directly on the device (an XLA
        fill — no host->device upload) and pushed
        through the same prep + dispatch flow.  Traces are
        shape-specialized, so ``nbytes`` must equal the real corpus
        length.  ``sample`` seeds the adaptive core tiers exactly as
        the real corpus would (pass the real head bytes: a zeros
        sample would synthesize a DIFFERENT core machine and compile
        the wrong trace).  Returns wall seconds spent.

        Production use (bench.py bench_multi): run this concurrently
        with host-only work — the native oracle count, corpus IO —
        so the compiles overlap instead of serializing ahead of the
        first scan.  The zeros stand-in
        scans clean (no escapes), so the warmup dispatch itself is
        cheap."""
        t0 = time.perf_counter()
        if self.dfa is None or not self.use_device or nbytes <= 0:
            return 0.0
        import numpy as np
        import jax.numpy as jnp
        from .ops.prep import prepare_auto
        spec = self._spec
        fct = (self._fused_core_tables(bytes(sample))
               if len(sample) else None)
        zeros_dev = jnp.zeros(nbytes, jnp.uint8)
        # host stand-in for the native tail walk: calloc'd zero pages
        # (only the ragged tail is ever touched)
        zeros_host = np.zeros(nbytes, np.uint8)
        if fct is not None and spec is not None:
            from .ops.pallas_core import core_count_fused, fused_chunk
            ck = fused_chunk(fct.inner, spec, chunk_len)
            if ck is not None:
                pc_ = prepare_auto(fct.inner, zeros_dev, ck)
                pf_ = prepare_auto(spec, zeros_dev, ck)
                _try_device(self, "fused-dispatch", "_fusedct",
                            lambda: core_count_fused(
                                fct, spec, zeros_host, chunk_len=ck,
                                prepared_core=pc_, prepared_full=pf_,
                                mesh=self.mesh))
                return time.perf_counter() - t0
        if spec is not None:
            from .ops.pallas_scan import spec_count_bytes
            p = prepare_auto(spec, zeros_dev, chunk_len,
                             b_multiple=(self.mesh.devices.size
                                         if self.mesh is not None
                                         else 1))
            _try_device(self, "spec-dispatch", "_spec",
                        lambda: spec_count_bytes(
                            spec, zeros_host, chunk_len, prepared=p,
                            mesh=self.mesh))
        return time.perf_counter() - t0

    def _scan_first(self, data, prepared=None):
        t0 = time.perf_counter()
        fct = (self._fused_core_tables(data)
               if len(data) >= self.DEVICE_THRESHOLD else None)
        if fct is not None:
            from .ops.pallas_core import core_scan_fused, fused_chunk
            spec = self._spec
            ck = fused_chunk(fct.inner, spec) if prepared else None
            r = _try_device(self, "fused-dispatch", "_fusedct",
                            lambda: core_scan_fused(
                                fct, spec, data,
                                prepared_core=prepared.for_tables(
                                    fct.inner, ck)
                                if prepared and ck else None,
                                prepared_full=prepared.for_tables(
                                    spec, ck)
                                if prepared and ck else None,
                                mesh=self.mesh))
            if r is None:
                self._fusedct = False
            else:
                state, first = r
                self._fused_note(fct)
                self._note_stats("scan", fct, len(data), t0)
                self._maybe_tier_ab(data)
                return first, state
        if len(data) >= self.DEVICE_THRESHOLD:
            ct = self._core_tables(data)
            if ct is not None:
                from .ops.pallas_core import core_scan_bytes
                r = _try_device(self, "core-dispatch", "_coret",
                                lambda: core_scan_bytes(
                                    ct, data,
                                    prepared=prepared.for_tables(ct.inner)
                                    if prepared else None,
                                    mesh=self.mesh))
                if r is not None:
                    state, first = r
                    self._core_note(ct)
                    self._note_stats("scan", ct, len(data), t0)
                    self._maybe_tier_ab(data)
                    return first, state
        if getattr(self, "_phi_active", False) \
                and len(data) >= self.DEVICE_THRESHOLD:
            from .ops.pallas_phi import phi_scan_bytes
            pt = self._phi_tables()
            r = _try_device(self, "phi-dispatch", "_phi",
                            lambda: phi_scan_bytes(
                                pt, data,
                                prepared=prepared.for_tables(pt)
                                if prepared else None))
            if r is not None:
                state, first = r
                self._note_stats("scan", pt, len(data), t0)
                return first, state
        if self._spec is not None and len(data) >= self.DEVICE_THRESHOLD:
            from .ops.pallas_scan import spec_scan_bytes
            spec = self._spec
            r = _try_device(self, "spec-dispatch", "_spec",
                            lambda: spec_scan_bytes(
                                spec, data,
                                prepared=prepared.for_tables(spec)
                                if prepared else None, mesh=self.mesh))
            if r is not None:
                state, first = r
                self._note_stats("scan", spec, len(data), t0)
                self._spec_note()
                return first, state
        r = self._native.scan_first(data, 0)
        self._note_stats("scan", None, len(data), t0)
        return r

    def match(self, data, prepared=None):
        if self.dfa is None:
            # lazy machine (+ lazy core device path) via scan()
            return self.scan(data, prepared) is not None
        first, state = self._scan_first(data, prepared)
        if first >= 0:
            return True
        return bool(self.dfa.match_eof[state])

    def scan(self, data, prepared=None):
        """Earliest match END with the matched regex id (Thompson
        semantics over the whole pattern set): returns
        (regex_id, end_boundary) or None.  end_boundary == len(data)
        means the match ends at EOF.

        The id never rides the device hot loop: the kernels locate the
        boundary, and the id is one match_id table lookup at the
        boundary state (the DFA analogue of the Pike VM reporting the
        first matching thread in priority order,
        sre_vm_pike.c:607-658)."""
        if self.dfa is None:
            lazy = self._lazy_dfa()
            t0 = time.perf_counter()
            ct = (self._lazy_core_tables(data)
                  if len(data) >= self.DEVICE_THRESHOLD else None)
            r = None
            if ct is not None:
                from .ops.pallas_core import core_scan_bytes
                r = _try_device(self, "core-dispatch", "_lazy_coret",
                                lambda: core_scan_bytes(
                                    ct, data,
                                    prepared=prepared.for_tables(ct.inner)
                                    if prepared else None))
            if r is not None:
                state, first = r
                self._core_note(ct, "_lazy_coret")
            else:
                ct = None
                first, state = lazy.scan_first(data, 0)
            self._note_stats("scan", ct, len(data), t0)
            if first >= 0:
                return lazy.id_at(state, data[first]), first
            rid = lazy.match_eof_id(state)
            return (rid, len(data)) if rid >= 0 else None
        first, state = self._scan_first(data, prepared)
        if first >= 0:
            return self.dfa.id_at(state, data[first]), first
        rid = int(self.dfa.match_eof_id[state])
        return (rid, len(data)) if rid >= 0 else None

    def count(self, data, prepared=None):
        """Number of match-ending boundaries (including EOF)."""
        t0 = time.perf_counter()
        if self.dfa is None:
            # patterns past the eager-DFA budget fall back to the lazy
            # machine (universality: no public API raises on size) —
            # with the lazy-backed core tier as the device fast path
            lazy = self._lazy_dfa()
            ct = (self._lazy_core_tables(data)
                  if len(data) >= self.DEVICE_THRESHOLD else None)
            r = None
            if ct is not None:
                from .ops.pallas_core import core_count_bytes
                r = _try_device(self, "core-dispatch", "_lazy_coret",
                                lambda: core_count_bytes(
                                    ct, data,
                                    prepared=prepared.for_tables(ct.inner)
                                    if prepared else None))
            if r is not None:
                state, c = r
                self._core_note(ct, "_lazy_coret")
            else:
                ct = None
                c, state = lazy.count(data, 0)
            self._note_stats("count", ct, len(data), t0)
            if lazy.match_eof(state):
                c += 1
            return c
        state = c = served = None
        fct = (self._fused_core_tables(data)
               if len(data) >= self.DEVICE_THRESHOLD else None)
        if fct is not None:
            from .ops.pallas_core import core_count_fused, fused_chunk
            spec = self._spec
            ck = fused_chunk(fct.inner, spec) if prepared else None
            r = _try_device(self, "fused-dispatch", "_fusedct",
                            lambda: core_count_fused(
                                fct, spec, data,
                                prepared_core=prepared.for_tables(
                                    fct.inner, ck)
                                if prepared and ck else None,
                                prepared_full=prepared.for_tables(
                                    spec, ck)
                                if prepared and ck else None,
                                mesh=self.mesh))
            if r is None:
                # disqualified (shape mismatch) or failed: declined
                self._fusedct = False
            else:
                state, c = r
                served = True
                self._fused_note(fct)
                self._note_stats("count", fct, len(data), t0)
                self._maybe_tier_ab(data)
        ct = (self._core_tables(data)
              if served is None
              and len(data) >= self.DEVICE_THRESHOLD else None)
        if ct is not None:
            from .ops.pallas_core import core_count_bytes
            r = _try_device(self, "core-dispatch", "_coret",
                            lambda: core_count_bytes(
                                ct, data,
                                prepared=prepared.for_tables(ct.inner)
                                if prepared else None, mesh=self.mesh))
            if r is not None:
                state, c = r
                served = True
                self._core_note(ct)
                self._note_stats("count", ct, len(data), t0)
                self._maybe_tier_ab(data)
        if served is None and getattr(self, "_phi_active", False) \
                and len(data) >= self.DEVICE_THRESHOLD:
            from .ops.pallas_phi import phi_count_bytes
            pt = self._phi_tables()
            r = _try_device(self, "phi-dispatch", "_phi",
                            lambda: phi_count_bytes(
                                pt, data,
                                prepared=prepared.for_tables(pt)
                                if prepared else None))
            if r is not None:
                state, c = r
                served = True
                self._note_stats("count", pt, len(data), t0)
        if served is None and self._spec is not None \
                and len(data) >= self.DEVICE_THRESHOLD:
            from .ops.pallas_scan import spec_count_bytes
            spec = self._spec
            r = _try_device(self, "spec-dispatch", "_spec",
                            lambda: spec_count_bytes(
                                spec, data,
                                prepared=prepared.for_tables(spec)
                                if prepared else None, mesh=self.mesh))
            if r is not None:
                state, c = r
                served = True
                self._note_stats("count", spec, len(data), t0)
                self._spec_note()
        if served is None:
            c, state = self._native.count(data, 0)
            self._note_stats("count", None, len(data), t0)
        if self.dfa.match_eof[state]:
            c += 1
        return c

    def _batch_eligible(self, docs):
        """The static device tier serves a batched scan when the
        combined corpus justifies one dispatch.  Per-document device
        gating would be wrong here — batching exists precisely so
        documents BELOW the single-buffer threshold share a dispatch."""
        if (self.dfa is None or self._spec is None
                or not self.use_device):
            return False
        return sum(len(d) for d in docs) >= self.DEVICE_THRESHOLD

    def _batch_core(self, docs):
        """Adaptive core tier for a BATCHED scan: same eligibility,
        decision bands, and Scanner-lifetime cache as the
        single-buffer path (_core_tables), with the corpus sample
        spread across the document set.  None when the core stays
        out (then the static batch path or the host loop serves)."""
        if (self.dfa is None or not self.use_device
                or sum(len(d) for d in docs) < self.DEVICE_THRESHOLD):
            return None
        sample = b"".join(bytes(d[:1 << 16]) for d in docs[:256])
        return self._core_tables(sample)

    def _batch_fused_core(self, docs):
        """Fused-band core tier for a BATCHED scan (the *_many
        analogue of _fused_core_tables): the document set's escaped
        chunks are redone by the full machine's kernel inside the one
        batch dispatch instead of one native host walk each.  None
        when the fused band doesn't apply (then the legacy batch core
        or static paths serve).  Single-chip only for now — a mesh
        Scanner's batches ride the legacy shard_mapped paths."""
        if (self.dfa is None or not self.use_device
                or self.mesh is not None
                or sum(len(d) for d in docs) < self.DEVICE_THRESHOLD):
            return None
        sample = b"".join(bytes(d[:1 << 16]) for d in docs[:256])
        return self._fused_core_tables(sample)

    def prepare_many(self, docs, chunk_len=2048, for_find=False):
        """Pack/upload a document set ONCE (PreparedBatch) for reuse
        across count_many/scan_many calls — the batch analogue of
        prepare().  ``for_find=True`` packs for the tagged-capture
        tables instead (reusable across find_many calls; the two
        packings differ when the machines' class maps do).  Returns
        None when the batch cannot take the device path (then the
        *_many calls simply loop)."""
        docs = [d if isinstance(d, (bytes, bytearray)) else bytes(d)
                for d in docs]
        full = None
        if for_find:
            tables = self._tdfa_spec
        else:
            fct = self._batch_fused_core(docs)
            ct = fct or self._batch_core(docs)
            tables = ct.inner if ct is not None else self._spec
            if fct is not None:
                # the fused batch needs the FULL machine's prep too;
                # align both on one chunk length
                from .ops.pallas_core import fused_chunk
                ck = fused_chunk(fct.inner, self._spec, chunk_len)
                full = self._spec if ck is not None else None
                chunk_len = ck if ck is not None else chunk_len
        if tables is None or not self.use_device \
                or sum(len(d) for d in docs) < self.DEVICE_THRESHOLD:
            return None
        from .ops.batch import batch_prepare, BatchUnsupported
        try:
            pb = batch_prepare(tables, docs, chunk_len)
            if full is not None:
                pb.full = batch_prepare(full, docs, chunk_len)
            return pb
        except BatchUnsupported:
            return None

    def count_many(self, docs, chunk_len=2048, prepared=None):
        """Per-document ``count()`` over a document SET in one device
        dispatch: every document is packed into a single chunk stream
        (document starts restart the automaton at the seed via the
        per-chunk entry planes — no kernel changes, ops/batch.py) and
        one kernel pass scans them all; each document's validation
        chain folds independently, so results are exactly
        ``[self.count(d) for d in docs]``.  Documents shorter than one
        chunk fold natively — lower chunk_len (quantum 16 bytes) to
        give small documents device coverage.  ``prepared`` reuses a
        prepare_many() handle built from the SAME documents."""
        docs = [d if isinstance(d, (bytes, bytearray)) else bytes(d)
                for d in docs]
        t0 = time.perf_counter()
        fct = self._batch_fused_core(docs)
        if fct is not None:
            from .ops.batch import (core_count_many_fused,
                                    BatchUnsupported)
            spec = self._spec

            def thunk():
                try:
                    return core_count_many_fused(
                        fct, spec, docs, chunk_len,
                        prepared_core=prepared,
                        prepared_full=getattr(prepared, "full", None))
                except BatchUnsupported:
                    return None     # no pad byte: legacy paths serve

            r = _try_device(self, "fused-batch", "_fusedct", thunk)
            if r is not None:
                counts, finals, nat, C = r
                fct.last_repair = (nat, C)
                self._note_stats("count_many", fct,
                                 sum(len(d) for d in docs), t0)
                eof = self.dfa.match_eof
                return [c + (1 if eof[s] else 0)
                        for c, s in zip(counts, finals)]
        ct = self._batch_core(docs)
        if ct is not None:
            from .ops.batch import core_count_many, BatchUnsupported
            try:
                counts, finals, nat, C = core_count_many(
                    ct, docs, chunk_len, prepared=prepared,
                    mesh=self.mesh)
            except BatchUnsupported:
                pass
            else:
                ct.last_repair = (nat, C)
                self._note_stats("count_many", ct,
                                 sum(len(d) for d in docs), t0)
                eof = self.dfa.match_eof
                return [c + (1 if eof[s] else 0)
                        for c, s in zip(counts, finals)]
        if self._batch_eligible(docs):
            from .ops.batch import spec_count_many, BatchUnsupported
            try:
                counts, finals, nat, C = spec_count_many(
                    self._spec, docs, chunk_len, prepared=prepared,
                    mesh=self.mesh)
            except BatchUnsupported:
                pass
            else:
                self._spec.last_repair = (nat, C)
                self._note_stats("count_many", self._spec,
                                 sum(len(d) for d in docs), t0)
                eof = self.dfa.match_eof
                return [c + (1 if eof[s] else 0)
                        for c, s in zip(counts, finals)]
        return [self.count(d) for d in docs]

    def scan_many(self, docs, chunk_len=2048, prepared=None):
        """Per-document ``scan()`` in one device dispatch: returns
        ``[self.scan(d) for d in docs]`` — (regex_id, end_boundary)
        or None per document."""
        docs = [d if isinstance(d, (bytes, bytearray)) else bytes(d)
                for d in docs]
        t0 = time.perf_counter()

        def resolve(results):
            out = []
            for (st, b), d in zip(results, docs):
                if b >= 0:
                    out.append((self.dfa.id_at(st, d[b]), b))
                else:
                    rid = int(self.dfa.match_eof_id[st])
                    out.append((rid, len(d)) if rid >= 0 else None)
            return out

        fct = self._batch_fused_core(docs)
        if fct is not None:
            from .ops.batch import (core_scan_many_fused,
                                    BatchUnsupported)
            spec = self._spec

            def thunk():
                try:
                    return core_scan_many_fused(
                        fct, spec, docs, chunk_len,
                        prepared_core=prepared,
                        prepared_full=getattr(prepared, "full", None))
                except BatchUnsupported:
                    return None

            r = _try_device(self, "fused-batch", "_fusedct", thunk)
            if r is not None:
                results, nat, C = r
                fct.last_repair = (nat, C)
                self._note_stats("scan_many", fct,
                                 sum(len(d) for d in docs), t0)
                return resolve(results)
        ct = self._batch_core(docs)
        if ct is not None:
            from .ops.batch import core_scan_many, BatchUnsupported
            try:
                results, nat, C = core_scan_many(
                    ct, docs, chunk_len, prepared=prepared,
                    mesh=self.mesh)
            except BatchUnsupported:
                pass
            else:
                ct.last_repair = (nat, C)
                self._note_stats("scan_many", ct,
                                 sum(len(d) for d in docs), t0)
                return resolve(results)
        if self._batch_eligible(docs):
            from .ops.batch import spec_scan_many, BatchUnsupported
            try:
                results, nat, C = spec_scan_many(
                    self._spec, docs, chunk_len, prepared=prepared,
                    mesh=self.mesh)
            except BatchUnsupported:
                pass
            else:
                self._spec.last_repair = (nat, C)
                self._note_stats("scan_many", self._spec,
                                 sum(len(d) for d in docs), t0)
                return resolve(results)
        return [self.scan(d) for d in docs]

    def match_many(self, docs, chunk_len=2048, prepared=None):
        """Per-document ``match()`` in one device dispatch."""
        return [r is not None
                for r in self.scan_many(docs, chunk_len, prepared)]

    def finditer_many(self, docs, chunk_len=2048, prepared=None):
        """Per-document ``findall()`` over a document SET: equals
        ``[self.findall(d) for d in docs]``.

        One batched scan dispatch (scan_many) filters the match-free
        documents exactly — a document whose scan DFA never reaches a
        match boundary (interior or EOF) has no Pike match anywhere,
        so only the MATCHING documents run host match resolution (the
        native TDFA walker / Pike re-arm loop).  This is the sparse
        grep-over-many-files serving shape: the device pass touches
        every byte once, the host only the matching documents.
        Reference analog: none (sregex iterates one buffer per exec
        re-arm, sre_vm_pike.c:624-635)."""
        docs = [d if isinstance(d, (bytes, bytearray)) else bytes(d)
                for d in docs]
        firsts = self.scan_many(docs, chunk_len, prepared)
        return [[] if f is None else self.findall(d)
                for f, d in zip(firsts, docs)]

    def sub_many(self, repl, docs, count=0, chunk_len=2048,
                 prepared=None):
        """Per-document ``sub()`` over a document SET: returns
        ``[(new_bytes, n_replacements), ...]``.  Match-free documents
        (the common case in sparse serving) are identified by ONE
        batched device dispatch and returned unchanged without host
        resolution; matching documents ride the exact sub loop."""
        docs = [d if isinstance(d, (bytes, bytearray)) else bytes(d)
                for d in docs]
        firsts = self.scan_many(docs, chunk_len, prepared)
        return [(bytes(d), 0) if f is None
                else self.sub(repl, d, count=count)
                for f, d in zip(firsts, docs)]

    def _stream_tables(self, segments):
        """Tables + segment iterator for the pipelined stream APIs.
        Peeks segments until DEVICE_THRESHOLD bytes accumulate (below
        it the host carry loop wins — mirrors the single-buffer
        gating; a short stream would pay per-segment dispatch+readback
        RTT and possibly a kernel compile).  When the adaptive core
        tier applies (static chain bottomed out, or no dense machine
        at all) and the first segment is big enough to sample, the
        core is built from it and rides the pipeline; otherwise the
        static tier.  Peeked segments are snapshotted (producers may
        reuse their read buffer between yields).  Returns (tables or
        None, iterator, drift_note_attr)."""
        import itertools
        it = iter(segments)
        peeked = []
        total = 0
        for seg in it:
            peeked.append(seg if isinstance(seg, bytes)
                          else bytes(seg))
            total += len(seg)
            if total >= self.DEVICE_THRESHOLD:
                break
        rest = itertools.chain(peeked, it)
        if total < self.DEVICE_THRESHOLD:
            return None, rest, None
        first = peeked[0]
        if len(first) >= self.CORE_SAMPLE:
            if self.dfa is not None:
                ct = self._core_tables(first)
                if ct is not None:
                    return ct, rest, "_coret"
            else:
                ct = self._lazy_core_tables(first)
                if ct is not None:
                    return ct, rest, "_lazy_coret"
        return self._spec if self.dfa is not None else None, \
            rest, None

    def count_stream(self, segments, chunk_len=2048, in_flight=2):
        """Pipelined streaming count: equivalent to
        ``count(b"".join(segments))`` without ever materializing the
        concatenation.  On the device path each segment's host->device
        upload overlaps the previous segment's kernel
        (ops/pipeline.py); cross-segment exactness rides the same
        speculation-validation chain as in-segment chunks.  Big
        automata stream on the adaptive core tier (sampled from the
        first segment).  Patterns without any device tier fall back
        to the native (or lazy) table walk with a plain state carry
        — the streaming semantics are identical either way."""
        t0 = time.perf_counter()
        if self.use_device:
            tables, segments, note = self._stream_tables(segments)
            if tables is not None:
                from .ops.pipeline import pipelined_count
                state, c = pipelined_count(
                    tables, segments, chunk_len=chunk_len,
                    in_flight=in_flight, mesh=self.mesh)
                if note is not None:
                    self._core_note(tables, note)
                elif tables is self._spec:
                    self._spec_note()
                self._note_stats(
                    "count_stream", tables,
                    getattr(tables, "last_fold_bytes", -1), t0)
                eof = (self.dfa.match_eof[state]
                       if self.dfa is not None
                       else self._lazy_dfa().match_eof(state))
                return c + (1 if eof else 0)
        eng = self._native if self.dfa is not None \
            else self._lazy_dfa()
        state, c = 0, 0
        nbytes = 0
        for seg in segments:
            if len(seg) == 0:
                continue
            k, state = eng.count(seg, state)
            c += k
            nbytes += len(seg)
        self._note_stats("count_stream", None, nbytes, t0)
        eof = (self.dfa.match_eof[state] if self.dfa is not None
               else self._lazy_dfa().match_eof(state))
        return c + (1 if eof else 0)

    def match_stream(self, segments, chunk_len=2048, in_flight=2):
        """True iff the concatenated stream contains a match
        (``match(b"".join(segments))``); stops dispatching shortly
        after the first match on an unbounded stream."""
        return self.scan_stream(segments, chunk_len=chunk_len,
                                in_flight=in_flight) is not None

    def scan_stream(self, segments, chunk_len=2048, in_flight=2):
        """Pipelined streaming earliest-match scan: equivalent to
        ``scan(b"".join(segments))``.  Returns (regex_id,
        end_boundary) or None; end == total stream length means the
        match ends at EOF.  Segments dispatched past the match are
        discarded unfolded, so feeding an unbounded stream terminates
        shortly after the first match."""
        t0 = time.perf_counter()
        if self.use_device:
            tables, segs, note = self._stream_tables(segments)
            if tables is not None:
                from .ops.pipeline import pipelined_scan
                state, first, byte, nbytes = pipelined_scan(
                    tables, segs, chunk_len=chunk_len,
                    in_flight=in_flight, mesh=self.mesh)
                if note is not None:
                    # drift/re-core bookkeeping: a scan-only
                    # streaming workload on a drifted corpus must
                    # still trigger the re-core/decline logic
                    self._core_note(tables, note)
                elif tables is self._spec:
                    self._spec_note()
                self._note_stats("scan_stream", tables, nbytes, t0)
                eng = self.dfa if self.dfa is not None \
                    else self._lazy_dfa()
                if first >= 0:
                    return eng.id_at(state, byte), first
                rid = (int(self.dfa.match_eof_id[state])
                       if self.dfa is not None
                       else self._lazy_dfa().match_eof_id(state))
                return (rid, nbytes) if rid >= 0 else None
            segments = segs
        eng = self._native if self.dfa is not None \
            else self._lazy_dfa()
        state, base = 0, 0
        for seg in segments:
            if len(seg) == 0:
                continue
            f, st = eng.scan_first(seg, state)
            if f >= 0:
                byte = seg[f]
                self._note_stats("scan_stream", None, base + f, t0)
                if self.dfa is not None:
                    return self.dfa.id_at(st, byte), base + f
                return self._lazy_dfa().id_at(st, byte), base + f
            state = st
            base += len(seg)
        self._note_stats("scan_stream", None, base, t0)
        if self.dfa is not None:
            rid = int(self.dfa.match_eof_id[state])
        else:
            rid = self._lazy_dfa().match_eof_id(state)
        return (rid, base) if rid >= 0 else None

    def _lazy_dfa(self):
        if getattr(self, "_lazy", None) is None:
            from .dfa import LazyDfa
            self._lazy = LazyDfa(self.program)
        return self._lazy

    def _lazy_core_tables(self, data):
        """Adaptive hot-core tier over the LAZY machine: patterns
        past the eager DFA budget (no dense machine exists) still get
        a device path when the sampled hot set is small.  Same
        protocol/caching as _core_tables; repairs run on the lazy
        Python walk, so the drift logic (_core_note) matters more
        here."""
        if getattr(self, "_lazy_coret", None) is None:
            self._lazy_coret = False
            import os
            if self.use_device and os.environ.get("SREGEX_CORE") != "0":
                try:
                    from .ops.pallas_core import LazyCoreTables
                    self._lazy_coret = LazyCoreTables(
                        self._lazy_dfa(), self._core_sample(data))
                except ValueError:
                    self._lazy_coret = False
        return self._lazy_coret or None

    def _tdfa_walker(self):
        """Native TDFA walker (native_tdfa.NativeTdfa) or None; built
        on first use, False-cached when the automaton exceeds the
        host budgets or the toolchain is unavailable."""
        if self._walker is None:
            import os
            if os.environ.get("SREGEX_FINDITER") == "pike":
                self._walker = False
            else:
                try:
                    from .native_tdfa import NativeTdfa
                    self._walker = NativeTdfa(self.program)
                except Exception:
                    self._walker = False
        return self._walker or None

    def _rev_dfa(self):
        if self._rev is False:
            self._rev = None
            self._rev_spec = None
            if self.ast is not None:
                try:
                    from .reverse import reverse_wrapped_ast
                    from .compiler import compile_regex
                    from .native import NativeDfa
                    rprog = compile_regex(reverse_wrapped_ast(self.ast))
                    rdfa = build_dfa(rprog)
                    self._rev = NativeDfa(rdfa)
                    if self.use_device:
                        self._rev_spec = _build_spec_tables(rdfa)
                except (DfaTooLarge, ValueError):
                    self._rev = None
        return self._rev

    def _rev_lazy_dfa(self):
        """Lazy reverse machine for patterns whose reverse subset
        construction exceeds the eager budget (the dense _rev_dfa is
        None).  Serves the finditer start locator via the lazy core
        tier."""
        if getattr(self, "_rev_lz", None) is None:
            self._rev_lz = False
            if self.ast is not None:
                try:
                    from .reverse import reverse_wrapped_ast
                    from .compiler import compile_regex
                    from .dfa import LazyDfa
                    self._rev_lz = LazyDfa(
                        compile_regex(reverse_wrapped_ast(self.ast)))
                except Exception:
                    self._rev_lz = False
        return self._rev_lz or None

    def _rev_lazy_core(self, data):
        """LazyCoreTables over the lazy REVERSE machine (sampled from
        the reversed corpus); cached per Scanner, False = declined."""
        if getattr(self, "_rev_lz_coret", None) is None:
            self._rev_lz_coret = False
            import os
            rl = self._rev_lazy_dfa()
            if rl is not None and self.use_device \
                    and os.environ.get("SREGEX_CORE") != "0":
                try:
                    from .ops.pallas_core import LazyCoreTables
                    self._rev_lz_coret = LazyCoreTables(
                        rl, self._core_sample(data)[::-1])
                except ValueError:
                    self._rev_lz_coret = False
        return self._rev_lz_coret or None

    def _tdfa_find(self, data, prepared=None, tables=None):
        """Device tagged-DFA find: one kernel pass yields the span,
        regex id, and tracked capture slots (ops/tdfa_scan.py).

        Returns (rid, ovector) for a certified match, (-1, None) for a
        certified no-match, or None when the device result cannot be
        certified exact (speculation miss / window-exceeding span) —
        the caller then runs the exact multi-pass path.
        """
        from .ops.tdfa_scan import tdfa_spec_find
        if tables is None:
            tables = self._tdfa_spec
        r = tdfa_spec_find(tables, data,
                           prepared=prepared.for_tables(tables)
                           if prepared else None)
        if r == "fallback":
            return None
        if r is None:
            return -1, None
        return self._tdfa_resolve(tables, r, data)

    def _tdfa_resolve(self, tables, r, data):
        """Map a certified (rid, bank) from the tagged kernel to the
        find() result (rid, user-ovector), resolving inner groups with
        a windowed Pike pass when only $0 pairs are tracked.  Returns
        None when the Pike resolution cannot certify (caller falls
        back to the multi-pass path)."""
        rid, bank = r
        prog = self.program
        t = tables.tdfa
        ofs = t.slice_ofs[rid]
        nslots = 2 * (prog.multi_ncaps[rid] + 1)
        if tables.tags == tuple(range(prog.ovecsize)):
            # every slot tracked: the bank IS the capture vector; lay
            # out the user ovector like prepare_matched_captures
            # (matched regex's slice first, -1 fill the rest)
            ov = [int(v) for v in bank[ofs:ofs + nslots]]
            ov += [-1] * (prog.ovecsize - len(ov))
            return rid, ov
        # partial tracking ($0 pairs only): the device pinned the
        # winner's start; Pike resolves inner groups over the match
        # region alone (same discipline as the reverse-scan path)
        ti = tables.tags.index(ofs)
        start = int(bank[ti])
        if nslots == 2:
            ov = [start, int(bank[ti + 1])]
            ov += [-1] * (prog.ovecsize - 2)
            return rid, ov
        ctx = self._pike_ctx()
        if start > 0:
            prev = data[start - 1]
            ctx.set_carry(start, prev == 10, sre_isword(prev))
        rc, _ = ctx.exec(data[start:], True)
        if rc < 0:
            return None
        return rc, [int(v) for v in ctx.ovector]

    def find_many(self, docs, chunk_len=2048, prepared=None):
        """Per-document ``find()`` (leftmost-first match WITH
        captures) in one tagged-kernel dispatch (ops/tdfa_scan.py
        tdfa_find_many): every document's chunk chain folds through
        the standard chunk-repair walk, so results are exactly
        ``[self.find(d) for d in docs]``; documents the kernel cannot
        certify take their own exact multi-pass find."""
        docs = [d if isinstance(d, (bytes, bytearray)) else bytes(d)
                for d in docs]
        t0 = time.perf_counter()
        tables = self._tdfa_spec
        total = sum(len(d) for d in docs)
        if (tables is not None and self.use_device
                and total >= self.DEVICE_THRESHOLD):
            from .ops.batch import BatchUnsupported
            from .ops.tdfa_scan import tdfa_find_many
            try:
                rs = tdfa_find_many(tables, docs, chunk_len,
                                    prepared=prepared)
            except BatchUnsupported:
                rs = None
            if rs is not None:
                out = []
                for r, d in zip(rs, docs):
                    if r == "fallback":
                        out.append(self.find(d))
                    elif r is None:
                        out.append(None)
                    else:
                        m = self._tdfa_resolve(tables, r, d)
                        # None: the windowed Pike resolution could
                        # not certify — exact multi-pass fallback
                        out.append(m if m is not None
                                   else self.find(d))
                self._note_stats("find_many", tables, total, t0)
                return out
        return [self.find(d) for d in docs]

    def _tdfa_core_tables(self, data):
        """Hot-core TDFA projection (ops/tdfa_scan.TdfaCoreTables)
        for tagged machines past the dense kernel budget: sampled
        from the corpus, cached per Scanner (False = declined).
        Exactness never depends on the sample — ESC escapes re-walk
        on the host TDFA in the chunk-repair fold."""
        if getattr(self, "_tdfa_coret", None) is None:
            self._tdfa_coret = False
            if self.use_device:
                try:
                    from .ops.tdfa_scan import TdfaCoreTables
                    self._tdfa_coret = TdfaCoreTables(
                        self.program, self._core_sample(data))
                except (DfaTooLarge, ValueError):
                    self._tdfa_coret = False
                except Exception as e:
                    degraded("tdfa-core-tier",
                             f"tagged hot-core construction failed "
                             f"({e!r})")
                    self._tdfa_coret = False
        return self._tdfa_coret or None

    def find(self, data, prepared=None):
        """Leftmost-first match with captures (Pike semantics).

        Fast path: the forward DFA proves a match exists, a REVERSE
        automaton scan of the reversed corpus locates the winner's
        start (the leftmost-first winner starts at the minimal start
        of any completed match), and the Pike engine resolves exact
        captures from there with the proper seen_word/seen_newline
        carry — only the match region is thread-simulated.
        """
        n = len(data)
        if self._tdfa_spec is not None and n >= self.DEVICE_THRESHOLD:
            # one-pass device path: the tagged-DFA kernel returns the
            # match span, regex id, and tracked capture slots directly
            # from device registers (ops/tdfa_scan.py); anything it
            # cannot certify exact falls through to the multi-pass path
            r = self._tdfa_find(data, prepared)
            if r is not None:
                rc, ov = r
                return (rc, ov) if rc >= 0 else None
        elif self.use_device and n >= self.DEVICE_THRESHOLD:
            # tagged machine past the dense kernel budget: the hot-
            # core TDFA projection (sampled from this corpus) keeps
            # the one-pass path; escapes repair chunk-wise on host,
            # and an uncertifiable result falls through as usual
            ct = self._tdfa_core_tables(data)
            if ct is not None:
                r = self._tdfa_find(data, prepared, tables=ct)
                if r is not None:
                    rc, ov = r
                    return (rc, ov) if rc >= 0 else None
        if self.dfa is not None:
            # DFA prefilter: no match end anywhere => no match at all
            first, state = self._scan_first(data, prepared)
            if first < 0 and not self.dfa.match_eof[state]:
                return None
            rev = self._rev_dfa()
            if rev is not None:
                rdata = data[::-1]
                rct = (self._rev_core_tables(data)
                       if n >= self.DEVICE_THRESHOLD else None)
                r = None
                if rct is not None:
                    from .ops.pallas_core import core_scan_last_bytes
                    r = _try_device(self, "core-dispatch",
                                    "_rev_coret",
                                    lambda: core_scan_last_bytes(
                                        rct, rdata))
                    if r is not None:
                        rstate, q = r
                        self._core_note(rct, "_rev_coret")
                if r is None and (self._rev_spec is not None
                                  and n >= self.DEVICE_THRESHOLD):
                    from .ops.pallas_scan import spec_scan_last_bytes
                    rspec = self._rev_spec
                    r = _try_device(self, "spec-dispatch",
                                    "_rev_spec",
                                    lambda: spec_scan_last_bytes(
                                        rspec, rdata))
                    if r is not None:
                        rstate, q = r
                if r is None:
                    q, rstate = rev.scan_last(rdata, 0)
                if rev.match_eof[rstate]:
                    s_star = 0            # a match starts at offset 0
                elif q >= 0:
                    s_star = n - q
                else:
                    s_star = None         # shouldn't happen; fall back
                if s_star is not None:
                    ctx = self._pike_ctx()
                    if s_star > 0:
                        prev = data[s_star - 1]
                        ctx.set_carry(s_star, prev == 10,
                                      sre_isword(prev))
                    rc, _ = ctx.exec(data[s_star:], True)
                    if rc >= 0:
                        return rc, [int(v) for v in ctx.ovector]
                    return None
        elif n >= self.DEVICE_THRESHOLD:
            # past-the-eager-budget pattern: the lazy machine (with
            # its device core tier) is the prefilter — no match end
            # anywhere means no match at all, without thread-
            # simulating the corpus
            if self.scan(data) is None:
                return None
            # locate the winner's start with the LAZY reverse machine
            # (same argument as the dense path: the leftmost-first
            # winner starts at the minimal completed-match start)
            rct = (self._rev_lazy_core(data)
                   if self.use_device else None)
            if rct is not None:
                from .ops.pallas_core import core_scan_last_bytes
                rstate, q = core_scan_last_bytes(rct, data[::-1])
                rl = self._rev_lazy_dfa()
                if rl.match_eof(rstate):
                    s_star = 0
                elif q >= 0:
                    s_star = n - q
                else:
                    s_star = None
                if s_star is not None:
                    ctx = self._pike_ctx()
                    if s_star > 0:
                        prev = data[s_star - 1]
                        ctx.set_carry(s_star, prev == 10,
                                      sre_isword(prev))
                    rc, _ = ctx.exec(data[s_star:], True)
                    if rc >= 0:
                        return rc, [int(v) for v in ctx.ovector]
                    return None
        ctx = self._pike_ctx()
        rc, _ = ctx.exec(data, True)
        if rc < 0:
            return None
        return rc, [int(v) for v in ctx.ovector]

    def make_index(self, data):
        """Build the reusable corpus index for device finditer: one
        REVERSE spec-kernel COUNT pass mapping every chunk that
        contains a completed-match START.  Build it once and pass to
        finditer(data, index=...) when iterating the same corpus more
        than once (production serving: the index lives beside the
        resident shard).  Returns None when no device reverse tables
        exist for this pattern."""
        rev = self._rev_dfa()
        if rev is not None:
            fct = self._rev_fused_core_tables(data)
            if fct is not None:
                # fused-band reverse machine: the chunk map's escapes
                # are redone on device (core_chunk_map_fused)
                return _StartLocator(rev, fct, data,
                                     full_tables=self._rev_spec)
            tables = self._rev_core_tables(data) or \
                getattr(self, "_rev_spec", None)
            if tables is None:
                return None
            return _StartLocator(rev, tables, data)
        # reverse machine past the eager budget: lazy reverse + lazy
        # core tier (monster patterns keep device-rate finditer)
        if not self.use_device:
            return None
        ct = self._rev_lazy_core(data)
        if ct is None:
            return None
        return _StartLocator(self._rev_lazy_dfa(), ct, data)

    def finditer(self, data, index=None):
        """Iterate successive matches (the substitution-loop protocol:
        after each final match the engine re-arms and continues from
        the match end, sre_vm_pike.c:624-635).

        Device fast path (use_device + large corpus, or an explicit
        ``index``): the reverse fire map (make_index) locates every
        completed-match START; between matches the Pike ctx teleports
        across start-free gaps instead of thread-simulating them.
        The teleport is exact: no completed-match starts in the gap
        means no thread alive at the teleport point can ever reach
        MATCH, so a fresh ctx with the boundary carry is
        indistinguishable.  Match resolution itself stays byte-exact
        Pike, fed in geometrically growing windows so the cost per
        match tracks the match region, not the corpus tail."""
        n = len(data)
        starts = index
        if starts is None and self.use_device \
                and n >= self.DEVICE_THRESHOLD:
            starts = self.make_index(data)
        if starts is None:
            # host path: the native TDFA walker emits every match's
            # captures from tagged-DFA registers (exact-mode
            # semantics; ~100x Pike on dense-match corpora)
            walker = self._tdfa_walker()
            if walker is not None:
                yield from walker.iter_ovectors(data)
                return
        ctx = self._pike_ctx()
        pos = 0
        while True:
            if starts is not None and pos < n:
                s_star = starts.next_start(pos)
                if s_star is None:
                    return
                if s_star > pos:
                    # teleport across the start-free gap
                    ctx = self._pike_ctx()
                    prev = data[s_star - 1]
                    ctx.set_carry(s_star, prev == 10, sre_isword(prev))
                    pos = s_star
            if starts is not None:
                rc = self._pike_stream(ctx, data, pos)
            else:
                rc, _ = ctx.exec(data[pos:], True)
            if rc < 0:
                return
            ov = [int(v) for v in ctx.ovector]
            yield rc, ov
            # the ctx re-armed at the match end (absolute offset)
            if ov[1] >= len(data) and ov[0] == ov[1]:
                return
            pos = ov[1]

    def findall(self, data, index=None):
        """All matches as a list of (regex_id, ovector) — finditer,
        collected (re.findall analogue with full ovectors)."""
        return list(self.finditer(data, index=index))

    def sub(self, repl, data, count=0, index=None):
        """Replace matches (the reference's production mode: the
        streaming substitution loop of ngx_replace_filter over
        sre_vm_pike re-arms, sre_vm_pike.c:624-635).  Returns
        (new_bytes, n_replacements).

        repl: bytes template — ``$0``..``$9`` / ``${nn}`` substitute
        capture groups of the matched regex ($0 = whole match; unset
        groups substitute empty), ``$$`` a literal dollar — or a
        callable (regex_id, ovector, data) -> bytes.  count limits
        replacements (0 = all).  Rides finditer, so large corpora get
        the device fast path (pass a prebuilt ``index`` to reuse the
        reverse fire map)."""
        out = []
        pos = 0
        done = 0
        for rid, ov in self.finditer(data, index=index):
            if count and done >= count:
                break
            out.append(data[pos:ov[0]])
            if callable(repl):
                out.append(repl(rid, ov, data))
            else:
                out.append(_expand_template(repl, ov, data))
            pos = ov[1]
            done += 1
        out.append(data[pos:])
        return b"".join(out), done

    def editor(self, repl, count=0):
        """Streaming substitution: returns a StreamEditor over this
        pattern set (chunk-in/chunk-out replace filter; see
        StreamEditor).  For throughput over large segmented streams
        use sub_stream (device fire map + Pike teleports); the editor
        optimizes latency (flushes as early as provably final)."""
        return StreamEditor(self, repl, count=count)

    def _events_engine(self, chunk_len, map_window):
        if self.dfa is None:
            return None
        from .events import StreamEvents
        return StreamEvents(self, chunk_len=chunk_len,
                            map_window=map_window)

    def finditer_stream(self, segments, chunk_len=2048,
                        map_window=8 << 20):
        """finditer over a segmented/unbounded stream: yields
        (regex_id, ovector) with ABSOLUTE stream offsets, identical to
        finditer(b"".join(segments)) for every segmentation, in
        O(map_window + teleport lookback) memory.

        Device fast path (events.py): a forward per-chunk fire map
        (one validated kernel pass per window) locates every chunk
        that can contain a match end; the Pike VM runs only around
        those fires and teleports across fire-free gaps — bounded
        patterns seed max_match_len before a fire, unbounded ones at
        sterile chunk boundaries (dfa.sterile).  Patterns past the
        eager DFA budget stream through the Pike re-arm loop
        directly."""
        eng = self._events_engine(chunk_len, map_window)
        if eng is None:
            yield from self._finditer_stream_pike(segments)
            return
        for seg in segments:
            yield from eng.push(seg)
        yield from eng.push(b"", eof=True)

    def _finditer_stream_pike(self, segments):
        """Monster-pattern fallback: the bare streaming re-arm loop
        (sre_vm_pike.c:624-635 as a stream consumer).  Memory is the
        pending-match bound, like StreamEditor."""
        ctx = self._pike_ctx()
        held = bytearray()
        hb = 0          # absolute offset of held[0] == ctx feed point
        total = 0
        segs = iter(segments)
        eof = False
        piece = b""
        while True:
            if not piece and not eof:
                nxt = next(segs, None)
                if nxt is None:
                    eof = True
                    piece = b""
                else:
                    piece = bytes(nxt)
                    held += piece
                    total += len(piece)
            rc, pending = ctx.exec(piece, eof, want_pending=True)
            piece = b""
            if rc >= 0:
                ov = [int(v) for v in ctx.ovector]
                yield rc, ov
                if ov[1] >= total and ov[0] == ov[1] and eof:
                    return
                del held[:ov[1] - hb]
                hb = ov[1]
                piece = bytes(held)
                if not piece and eof:
                    # drain the re-armed engine at eof
                    continue
            elif rc == SRE_AGAIN:
                if eof:
                    return
                # release bytes no future re-feed can need: re-feeds
                # start at match ends >= any pending/candidate start
                bound = total
                t0 = int(ctx.ovector[0])
                if t0 >= 0:
                    bound = min(bound, t0)
                if pending is not None:
                    bound = min(bound, int(pending[0]))
                if bound > hb:
                    del held[:bound - hb]
                    hb = bound
            else:
                return

    def sub_stream(self, repl, segments, count=0, chunk_len=2048,
                   map_window=8 << 20):
        """Streaming replace over a segmented stream: yields output
        byte pieces whose concatenation equals
        sub(repl, b"".join(segments)) for every segmentation — the
        reference's production replace filter
        (README.markdown:609-611) at device rate (the fire-map events
        engine of finditer_stream).  repl: template or callable as
        Scanner.sub; count limits replacements (0 = all), after which
        the stream passes through verbatim."""
        eng = self._events_engine(chunk_len, map_window)
        if eng is None:
            ed = StreamEditor(self, repl, count=count)
            for seg in segments:
                out = ed.feed(seg)
                if out:
                    yield out
            if not ed.finished:
                out = ed.feed(b"", eof=True)
                if out:
                    yield out
            return
        emitted = 0
        done = 0
        passthrough = False
        eng.keep_from = 0

        def render(events, eof):
            nonlocal emitted, done, passthrough
            out = []
            for rid, ov in events:
                if passthrough:
                    continue
                out.append(eng.read(emitted, ov[0]))
                window = eng.read(ov[0], ov[1])
                rel = [v - ov[0] if v >= 0 else -1 for v in ov]
                if callable(repl):
                    out.append(repl(rid, rel, window))
                else:
                    out.append(_expand_template(repl, rel, window))
                emitted = ov[1]
                done += 1
                if count and done >= count:
                    passthrough = True
            bound = eng.total if (eof or passthrough) else eng.final
            if bound > emitted:
                out.append(eng.read(emitted, bound))
                emitted = bound
            eng.keep_from = emitted
            return b"".join(out)

        for seg in segments:
            out = render(eng.push(seg), False)
            if out:
                yield out
        out = render(eng.push(b"", eof=True), True)
        if out:
            yield out

    def split(self, data, maxsplit=0, index=None):
        """Split ``data`` around matches (re.split analogue without
        group interpolation): returns the list of between-match
        segments.  maxsplit limits splits (0 = all).  Rides finditer,
        so large corpora get the device fast path."""
        out = []
        pos = 0
        done = 0
        for _rid, ov in self.finditer(data, index=index):
            if maxsplit and done >= maxsplit:
                break
            out.append(data[pos:ov[0]])
            pos = ov[1]
            done += 1
        out.append(data[pos:])
        return out

    @staticmethod
    def _pike_stream(ctx, data, pos, first=1 << 16):
        """Drive the Pike ctx with geometrically growing chunks from
        ``pos`` until it resolves (the engines are streaming-native;
        matches usually commit within the first window, so the work
        per match is O(match region), not O(corpus tail))."""
        n = len(data)
        win = first
        while True:
            hi = min(pos + win, n)
            rc, _ = ctx.exec(data[pos:hi], hi >= n)
            if rc != SRE_AGAIN:
                return rc
            pos = hi
            win *= 4


def _expand_template(repl, ov, data):
    """Expand $0..$9 / ${nn} / $$ in a replacement template against
    one match's ovector (the ngx_replace_filter template dialect)."""
    out = []
    i = 0
    n = len(repl)
    while i < n:
        c = repl[i:i + 1]
        if c != b"$" or i + 1 >= n:
            out.append(c)
            i += 1
            continue
        nxt = repl[i + 1:i + 2]
        if nxt == b"$":
            out.append(b"$")
            i += 2
        elif nxt == b"{":
            j = repl.find(b"}", i + 2)
            if j < 0 or not repl[i + 2:j].isdigit():
                out.append(c)
                i += 1
                continue
            g = int(repl[i + 2:j])
            out.append(_group(ov, g, data))
            i = j + 1
        elif nxt.isdigit():
            g = int(nxt)
            out.append(_group(ov, g, data))
            i += 2
        else:
            out.append(c)
            i += 1
    return b"".join(out)


def _group(ov, g, data):
    lo = 2 * g
    if lo + 1 >= len(ov) or ov[lo] < 0:
        return b""
    return data[ov[lo]:ov[lo + 1]]


class StreamEditor:
    """Streaming substitution over an unbounded chunked stream — the
    reference's flagship production use case (ngx_replace_filter over
    the Pike re-arm loop, sre_vm_pike.c:624-635; buffering contract
    from the pending/temp-capture outputs, README.markdown:558-563,
    sre_vm_pike.c:640-658,692-735).

    feed(chunk, eof=False) -> bytes: consume one input chunk, return
    the next piece of edited output.  Output is emitted as early as
    provably final: after every chunk the engine's temp captures (the
    conservative $0 span over live threads) and the pending-match span
    bound the bytes that could still belong to a match; everything
    before that bound is flushed verbatim.  Total memory is
    O(longest potential match), independent of stream length.

    repl: bytes template ($0..$9 / ${nn} / $$, as Scanner.sub) or a
    callable (regex_id, ovector, window) -> bytes where ``ovector``
    indexes into ``window`` (the held byte window containing the
    match).  count limits replacements (0 = all); once reached the
    remainder of the stream passes through verbatim.

    The concatenated output equals Scanner.sub(repl, whole_stream)
    for every chunking (tests/test_editor.py fuzzes this).
    """

    def __init__(self, scanner, repl, count=0):
        self.scanner = scanner
        self.repl = repl
        self.count = count
        self.n_replacements = 0
        self._ctx = scanner._pike_ctx()
        self._held = bytearray()   # input bytes [held_base, total)
        self._held_base = 0        # == absolute bytes emitted so far
        self._total = 0            # absolute bytes received
        self._passthrough = False  # count reached: verbatim tail
        self._finished = False

    @property
    def finished(self):
        return self._finished

    def feed(self, chunk, eof=False):
        """Feed one chunk (b"" allowed); eof=True on the last call.
        Returns the output bytes that became final.  Feeding after
        eof is misuse and raises (the reference's SRE_ERROR contract,
        sre_vm_pike.c:165-168)."""
        if self._finished:
            raise RuntimeError("stream already finished")
        chunk = bytes(chunk or b"")
        self._total += len(chunk)
        if self._passthrough:
            if eof:
                self._finished = True
            self._held_base = self._total
            return chunk
        self._held += chunk
        out = []
        piece = chunk
        while True:
            rc, pending = self._ctx.exec(piece, eof, want_pending=True)
            if rc >= 0:
                ov = [int(v) for v in self._ctx.ovector]
                a, b = ov[0], ov[1]
                # every final match starts at/after the flush bound:
                # a < held_base would mean we emitted match bytes
                assert a >= self._held_base, (a, self._held_base)
                out.append(bytes(self._held[:a - self._held_base]))
                window = bytes(self._held)
                rel = [v - self._held_base if v >= 0 else -1
                       for v in ov]
                if callable(self.repl):
                    out.append(self.repl(rc, rel, window))
                else:
                    out.append(_expand_template(self.repl, rel, window))
                del self._held[:b - self._held_base]
                self._held_base = b
                self.n_replacements += 1
                if self.count and self.n_replacements >= self.count:
                    out.append(bytes(self._held))
                    self._held.clear()
                    self._held_base = self._total
                    self._passthrough = True
                    if eof:
                        self._finished = True
                    return b"".join(out)
                # the engine re-armed at b: re-feed the already-
                # received tail (the reference caller's re-feed loop)
                piece = bytes(self._held)
                if not piece and not eof:
                    break
            elif rc == SRE_AGAIN:
                bound = self._total
                t0 = int(self._ctx.ovector[0])
                if t0 >= 0:
                    bound = min(bound, t0)
                if pending is not None:
                    bound = min(bound, int(pending[0]))
                if bound > self._held_base:
                    out.append(bytes(
                        self._held[:bound - self._held_base]))
                    del self._held[:bound - self._held_base]
                    self._held_base = bound
                break
            elif rc == SRE_DECLINED:
                out.append(bytes(self._held))
                self._held.clear()
                self._held_base = self._total
                self._finished = True
                break
            else:
                self._finished = True
                raise RuntimeError("pike engine error (SRE_ERROR)")
        if eof:
            self._finished = True
        return b"".join(out)


class _StartLocator:
    """Locates the next completed-match START at or after a position,
    from one reverse-automaton COUNT pass (ops/pallas_scan.py
    spec_chunk_map over the reversed corpus).

    Reverse boundary q fires  <=>  some match starts at n - q
    (reverse.py; the same relation find() uses).  next_start walks the
    per-chunk fire counts from the boundary n - pos downward —
    monotone across calls, so the walk is amortized one pass."""

    CHUNK = 2048

    def __init__(self, rev_native, rev_tables, data,
                 full_tables=None):
        from .ops.pallas_core import CoreTables, core_chunk_map
        from .ops.pallas_scan import effective_chunk
        self.n = len(data)
        self.rdata = data[::-1]
        self.rev = rev_native
        from .ops.pallas_core import LazyCoreTables
        if full_tables is not None and isinstance(rev_tables,
                                                  CoreTables):
            # fused two-phase chunk map (round 5): escaped chunks are
            # redone by the full reverse machine's kernel on device
            from .ops.pallas_core import (core_chunk_map_fused,
                                          fused_chunk)
            ck = fused_chunk(rev_tables.inner, full_tables,
                             self.CHUNK)
            r = core_chunk_map_fused(rev_tables, full_tables,
                                     self.rdata, ck or self.CHUNK) \
                if ck is not None else None
            if r is not None:
                self.CHUNK = ck
                self.entries, self.counts, final = r
                me = rev_native.match_eof
                self.start0 = bool(me(final)) if callable(me) else \
                    bool(me[final])
                self.C = len(self.counts)
                return
            # shapes disqualified the fused path: legacy chunk map
        if isinstance(rev_tables, (CoreTables, LazyCoreTables)):
            # the prep may clamp K (the tables' max_chunk); the
            # locator's position math must agree with it
            self.CHUNK = effective_chunk(rev_tables.inner, self.CHUNK)
            self.entries, self.counts, final = core_chunk_map(
                rev_tables, self.rdata, self.CHUNK)
        else:
            from .ops.pallas_scan import spec_chunk_map
            self.CHUNK = effective_chunk(rev_tables, self.CHUNK)
            self.entries, self.counts, final = spec_chunk_map(
                rev_tables, self.rdata, self.CHUNK)
        me = rev_native.match_eof
        self.start0 = bool(me(final)) if callable(me) else \
            bool(me[final])
        self.C = len(self.counts)

    def next_start(self, pos):
        """Smallest s >= pos such that a completed match starts at s,
        else None."""
        n, K = self.n, self.CHUNK
        if pos <= 0 and self.start0:
            return 0
        Q = n - max(pos, 1)          # max reverse boundary of interest
        if Q < 0:
            return None
        c = min(Q // K, self.C - 1)
        while c >= 0:
            if self.counts[c]:
                lo = c * K
                hi_b = min(K - 1, Q - lo)
                if hi_b >= 0:
                    q_local, _ = self.rev.scan_last(
                        self.rdata[lo:lo + hi_b + 1],
                        int(self.entries[c]))
                    if q_local >= 0:
                        return n - (lo + q_local)
            c -= 1
        return None


def compile_pattern(pattern, flags=0, use_device=False, mesh=None):
    """One-call convenience: pattern (str/bytes) or list of patterns ->
    Scanner.  use_device=True enables the device scan tiers for large
    corpora (the host engines still serve small inputs); mesh= shards
    the device scans across a jax.sharding.Mesh."""
    from .parser import parse, parse_multi
    from .compiler import compile_regex
    if isinstance(pattern, (list, tuple)):
        ast, _ = parse_multi(list(pattern),
                             [flags] * len(pattern)
                             if isinstance(flags, int) else flags)
    else:
        ast, _ = parse(pattern, flags)
    return Scanner(compile_regex(ast), ast=ast,
                   use_device=use_device, mesh=mesh)
