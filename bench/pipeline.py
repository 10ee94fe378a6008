"""A/B: pipelined segmented ingestion vs sequential prepare+scan.

Usage:  python bench/pipeline.py [total_mb] [segment_mb] [reps]

Cold-ingestion scenario: the corpus arrives as host-resident segments
(file/network reads) and every byte must be uploaded, prepped, and
scanned once.  Arm A dispatches segment i+1's upload+prep while
segment i's kernel runs (ops/pipeline.py); arm B runs the classic
sequential loop (prepare_auto(block=True) then count, per segment,
carrying the state).  Arms are interleaved within ONE process.

The overlap benefit is bounded by min(upload, walk) per segment; on
the GPU neither has been measured yet.  The first dispatch of the
segment-sized block shape compiles.
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def corpus(total):
    unit = b"abccc" * (1 << 20) + b"aaabbccb"
    reps = -(-total // len(unit))
    return (unit * reps)[:total]


def main():
    total = (int(sys.argv[1]) if len(sys.argv) > 1 else 256) << 20
    seg_mb = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    seg = seg_mb << 20

    from sregex_tpu import parse, compile_regex
    from sregex_tpu.dfa import build_dfa
    from sregex_tpu.stream import _build_spec_tables
    from sregex_tpu.ops.pipeline import pipelined_count
    from sregex_tpu.ops.prep import prepare_auto
    from sregex_tpu.ops.pallas_scan import spec_count_bytes

    ast, _ = parse("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
    dfa = build_dfa(compile_regex(ast))
    tables = _build_spec_tables(dfa)
    data = corpus(total)
    segments = [data[i:i + seg] for i in range(0, len(data), seg)]
    print("total %.0f MB, %d segments of %d MB, tables=%s" % (
        total / 2**20, len(segments), seg_mb, type(tables).__name__))

    def arm_pipe():
        _st, c = pipelined_count(tables, segments)
        return c

    def arm_seq():
        st, c = 0, 0
        for s in segments:
            prepared = prepare_auto(tables, np.frombuffer(s, np.uint8),
                                    2048)
            st, k = spec_count_bytes(tables, s, prepared=prepared,
                                     entry_state=st)
            c += k
        return c

    # warm both traces (first-compile excluded from timing)
    wa, wb = arm_pipe(), arm_seq()
    assert wa == wb, (wa, wb)
    for r in range(reps):
        for name, fn in (("pipelined", arm_pipe),
                         ("sequential", arm_seq)):
            t0 = time.perf_counter()
            c = fn()                      # folds force value readbacks
            dt = time.perf_counter() - t0
            print("rep %d %-10s  %.3f s  %.2f GB/s  (count=%d)" % (
                r, name, dt, total / dt / 1e9, c))


if __name__ == "__main__":
    main()
