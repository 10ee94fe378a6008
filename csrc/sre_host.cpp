// Native host runtime for sregex-tpu.
//
// The device owns the bulk scan (ops/pallas_scan.py); this C++ module is the
// host-side fast path for the same DFA tables: streaming scans over
// chunks that are too small to be worth a device round-trip, match
// counting, and the leading-byte prefilter.  It plays the role the
// hand-written C VMs + DynASM JIT play in the reference
// (/root/reference/src/sregex/sre_vm_thompson.c, sre_vm_pike.c,
// sre_vm_thompson_x64.dasc) — but driven by the ahead-of-time DFA
// tables instead of per-byte NFA simulation.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>

extern "C" {

// Fused table layout: fused[state*256 + byte] = next_state | match<<20
// (match = a match ends at the boundary BEFORE consuming this byte,
// given the current state; see sregex_tpu/ops/scan.py).
static const int32_t kMatchShift = 20;
static const int32_t kStateMask = (1 << kMatchShift) - 1;

// Scan until the first match boundary.  Returns the boundary offset
// (0..n-1) or -1 if no match boundary occurs inside the buffer.
// *state_io carries the DFA state across calls (streaming resume).
int64_t sre_dfa_scan_first(const int32_t* fused, const uint8_t* data,
                           int64_t n, int32_t* state_io) {
    int32_t s = *state_io;
    for (int64_t i = 0; i < n; i++) {
        int32_t e = fused[(s << 8) | data[i]];
        if (e >> kMatchShift) {
            *state_io = s;
            return i;
        }
        s = e & kStateMask;
    }
    *state_io = s;
    return -1;
}

// Scan recording the LAST boundary (0..n-1) at which a match ends;
// returns it (or -1) and carries the state across the whole buffer.
int64_t sre_dfa_scan_last(const int32_t* fused, const uint8_t* data,
                          int64_t n, int32_t* state_io) {
    int32_t s = *state_io;
    int64_t last = -1;
    for (int64_t i = 0; i < n; i++) {
        int32_t e = fused[(s << 8) | data[i]];
        if (e >> kMatchShift) last = i;
        s = e & kStateMask;
    }
    *state_io = s;
    return last;
}

// Count every boundary (0..n-1) at which a match ends; returns the
// count and carries the state.  (The EOF boundary is the caller's.)
int64_t sre_dfa_count(const int32_t* fused, const uint8_t* data,
                      int64_t n, int32_t* state_io) {
    int32_t s = *state_io;
    int64_t count = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t e = fused[(s << 8) | data[i]];
        count += (e >> kMatchShift);
        s = e & kStateMask;
    }
    *state_io = s;
    return count;
}

// Enumerative transfer function: run the chunk from every entry state
// in [0, nstates): phi[s] = exit state, fm[s] = first match boundary
// offset or -1.  This is the host mirror of the device chunk_transfer
// kernel, used for cross-validation and for CPU-side sharding.
void sre_dfa_transfer(const int32_t* fused, int32_t nstates,
                      const uint8_t* data, int64_t n,
                      int32_t* phi, int64_t* fm) {
    for (int32_t s0 = 0; s0 < nstates; s0++) {
        int32_t s = s0;
        int64_t first = -1;
        for (int64_t i = 0; i < n; i++) {
            int32_t e = fused[(s << 8) | data[i]];
            if (first < 0 && (e >> kMatchShift)) first = i;
            s = e & kStateMask;
        }
        phi[s0] = s;
        fm[s0] = first;
    }
}

// memchr-style prefilter: first offset >= 0 whose byte is accepted by
// the 256-entry mask, or n.
// Visit-count sampling for the adaptive hot-core kernel tier
// (sregex_tpu/ops/pallas_core.py): walk the fused table over a data
// sample, incrementing counts[s] for the state held BEFORE each byte.
// Carries the state like the scan entry points.
void sre_dfa_visits(const int32_t* fused, const uint8_t* data,
                    int64_t n, int32_t* state_io, int64_t* counts) {
    int32_t s = *state_io;
    for (int64_t i = 0; i < n; i++) {
        counts[s]++;
        s = fused[(s << 8) | data[i]] & kStateMask;
    }
    *state_io = s;
}

int64_t sre_find_first_byte(const uint8_t* accept, const uint8_t* data,
                            int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        if (accept[data[i]]) return i;
    }
    return n;
}

}  // extern "C"

extern "C" {

// ---- Lazy-DFA resumable walkers ------------------------------------
//
// The lazy machine (sregex_tpu/dfa.py LazyDfa) materializes subset
// states on demand in Python; these walkers run the hot loop over a
// DENSE int64 mirror of the already-materialized transitions and stop
// at the first unmaterialized entry, returning control to Python to
// materialize that one entry and resume.  Past-the-eager-budget
// patterns thus scan at table-walk C speed once their hot set has
// materialized — the lazy analogue of the reference JIT's
// universality (sre_vm_thompson_jit.c:39 compiles every program).
//
// Dense entry encoding: -1 = unmaterialized, else
// (next_sid << 32) | (match_id + 1) — the match ends at the boundary
// BEFORE the byte (0 = no match), matching LazyDfa._step.
//
// Each walker returns the number of bytes consumed (== n when the
// buffer completed; < n means tab[state*ncls + cmap[data[consumed]]]
// needs materializing, with *state_io the state at that point).

int64_t sre_lazy_count(const int64_t* tab, int32_t ncls,
                       const uint8_t* cmap, const uint8_t* data,
                       int64_t n, int32_t* state_io,
                       int64_t* count_io) {
    int32_t s = *state_io;
    int64_t cnt = 0, i = 0;
    for (; i < n; i++) {
        int64_t e = tab[(int64_t) s * ncls + cmap[data[i]]];
        if (e < 0) break;
        cnt += (e & 0xffffffffLL) != 0;
        s = (int32_t)(e >> 32);
    }
    *state_io = s;
    *count_io += cnt;
    return i;
}

// Stops at the first match boundary: *found_io = its offset within
// THIS call's data and *state_io = the state AT the boundary
// (id_at-compatible), or *found_io = -1 when the consumed span holds
// no match boundary.
int64_t sre_lazy_scan_first(const int64_t* tab, int32_t ncls,
                            const uint8_t* cmap, const uint8_t* data,
                            int64_t n, int32_t* state_io,
                            int64_t* found_io) {
    int32_t s = *state_io;
    int64_t i = 0;
    *found_io = -1;
    for (; i < n; i++) {
        int64_t e = tab[(int64_t) s * ncls + cmap[data[i]]];
        if (e < 0) break;
        if ((e & 0xffffffffLL) != 0) {
            *found_io = i;
            *state_io = s;
            return i;
        }
        s = (int32_t)(e >> 32);
    }
    *state_io = s;
    return i;
}

// Records the LAST match boundary within this call's consumed span
// into *last_io (offset within this call's data; untouched when none
// — the caller pre-sets -1 and rebases across resumes).
int64_t sre_lazy_scan_last(const int64_t* tab, int32_t ncls,
                           const uint8_t* cmap, const uint8_t* data,
                           int64_t n, int32_t* state_io,
                           int64_t* last_io) {
    int32_t s = *state_io;
    int64_t i = 0;
    for (; i < n; i++) {
        int64_t e = tab[(int64_t) s * ncls + cmap[data[i]]];
        if (e < 0) break;
        if ((e & 0xffffffffLL) != 0) *last_io = i;
        s = (int32_t)(e >> 32);
    }
    *state_io = s;
    return i;
}

}  // extern "C"

extern "C" {

// Corpus preparation for the speculative device kernel
// (sregex_tpu/ops/pallas_scan.py): class-map each byte, window each
// K-byte chunk with W warmup bytes from its predecessor, pack CPW
// 4-bit classes per int32 word, and lay out
// [B, J/CPW, G, 8, 128] with chunk c = ((b*G+g)*1024 + lane).
// One sequential read pass per chunk; parallel over chunks.
void sre_pack_prepare(const uint8_t* data, int64_t n,
                      const uint8_t* cmap, int32_t K, int32_t W,
                      int32_t G, int64_t Cp, int32_t* out) {
    const int32_t J = W + K;
    const int32_t Jw = J / 8;
    const int64_t TILE = 1024;
    const int64_t stride_w = (int64_t) G * 8 * 128;  // int32 elements
#pragma omp parallel for schedule(static)
    for (int64_t c = 0; c < Cp; c++) {
        const int64_t b = c / (G * TILE);
        const int64_t r = c % (G * TILE);
        const int64_t g = r / TILE;
        const int64_t t = r % TILE;
        int32_t* base = out + ((b * Jw * G + g) * 8 + t / 128) * 128
                        + (t % 128);
        const int64_t pos0 = c * (int64_t) K - W;
        for (int32_t w = 0; w < Jw; w++) {
            uint32_t word = 0;
            const int64_t p0 = pos0 + (int64_t) w * 8;
            if (p0 >= 0 && p0 + 8 <= n) {
                for (int k = 0; k < 8; k++) {
                    word |= (uint32_t) cmap[data[p0 + k]] << (4 * k);
                }
            } else {
                for (int k = 0; k < 8; k++) {
                    const int64_t p = p0 + k;
                    if (p >= 0 && p < n) {
                        word |= (uint32_t) cmap[data[p]] << (4 * k);
                    }
                }
            }
            base[(int64_t) w * stride_w] = (int32_t) word;
        }
    }
}

}  // extern "C"
