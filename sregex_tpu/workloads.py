"""The benchmark's two workloads, shared by bench.py and chip_smoke.py.

headline: the reference bench methodology (bench/gen-data.pl:9 corpus
  "abccc" repeated; bench/Makefile:38 pattern
  '(?:a|b)aa(?:aa|bb)cc(?:a|b)'), scaled to ``mb`` megabytes with one
  match planted near the end.
multi: ~90 distinct keywords compiled into ONE combined DFA (the
  reference's multi-regex API, README.markdown:70-72 — the log
  scanning / routing shape), counted over text from a disjoint
  vocabulary with a keyword planted every 64 KB.
"""

import random

HEADLINE_PATTERN = "(?:a|b)aa(?:aa|bb)cc(?:a|b)"
HEADLINE_PLANT = b"xaaabbccb"

MULTI_WORDS = """error warning failure timeout retry connect disconnect login logout session
token refresh expired invalid denied granted access request response header
payload buffer overflow underflow socket stream packet frame segment router
gateway proxy cache miss hit evict flush commit rollback begin transaction
deadlock conflict replica shard leader follower election heartbeat snapshot
compact merge split index query plan execute fetch cursor batch queue topic
partition offset consumer producer broker cluster node zone region latency
throughput quota limit throttle backoff jitter circuit breaker fallback
primary secondary standby failover recover restore backup archive purge""".split()

_FILLER = ("alpha bravo delta golf hotel juliet kilo lima mike november "
           "oscar papa quebec romeo sierra tango uniform victor whiskey "
           "xray yankee zulu").split()


def headline_corpus(mb):
    """Match-free "abccc" body of ``mb`` MB with one match planted
    1/256 from the end (the scan must return its end boundary)."""
    body = b"abccc" * (1024 * 1024 * (mb // 5))
    ofs = (len(body) * 255 // 256) // 5 * 5 + 2
    corpus = body[:ofs] + HEADLINE_PLANT + body[ofs + len(HEADLINE_PLANT):]
    return corpus


def multi_patterns():
    return [w.encode() for w in MULTI_WORDS]


def multi_corpus(mb, seed=1234):
    """Filler text with a dictionary keyword planted every 64 KB."""
    rng = random.Random(seed)
    pats = multi_patterns()
    filler = [w.encode() for w in _FILLER]
    piece = b" ".join(rng.choice(filler) for _ in range(512)) + b" "
    body = piece * (mb * (1 << 20) // len(piece) + 1)
    out = bytearray(body[:mb << 20])
    del body
    step = 64 << 10
    for pos in range(step, len(out) - 64, step):
        w = pats[rng.randrange(len(pats))]
        out[pos:pos + len(w) + 2] = b" " + w + b" "
    return bytes(out)
