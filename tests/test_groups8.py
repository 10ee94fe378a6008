"""G=8 layout coverage on the CPU mesh: the production default since
round 4 (conftest pins G=4 to keep the CPU tests small, so this module runs
ONE exactness pass at G=8 in a subprocess with the production
default)."""

import os
import subprocess
import sys

import pytest

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
os.environ["SREGEX_GROUPS"] = "8"
os.environ["SREGEX_TIER_AB"] = "0"
import jax
jax.config.update("jax_platforms", "cpu")
import random
from sregex_tpu.ops.pallas_scan import GROUPS
assert GROUPS == 8, GROUPS
from sregex_tpu.stream import compile_pattern
rng = random.Random(4)
sc = compile_pattern("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
sc.use_device = True
sc.__init__(sc.program, use_device=True, ast=sc.ast)
sc.DEVICE_THRESHOLD = 1 << 12
data = bytearray(rng.choice(b"abc ") for _ in range(300_000))
data[7000:7008] = b"baaaaccb"
data = bytes(data)
host = compile_pattern("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
assert sc.count(data) == host.count(data)
assert sc.scan(data) == host.scan(data)
assert sc.stats().tier.startswith("SpecTables"), sc.stats().tier
print("G8_OK")
"""


def test_g8_layout_exact():
    r = subprocess.run([sys.executable, "-c", _SCRIPT],
                       capture_output=True, text=True, timeout=560,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert "G8_OK" in r.stdout, (r.stdout[-2000:], r.stderr[-2000:])


_SCRIPT_FUSED_CAP = r"""
import os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
os.environ["SREGEX_GROUPS"] = "8"
os.environ["SREGEX_FUSED_CAP"] = "4096"
os.environ["SREGEX_TIER_AB"] = "0"
import jax
jax.config.update("jax_platforms", "cpu")
import random
from sregex_tpu.ops.pallas_scan import (GROUPS, SpecTables,
                                        SpecTablesWide)
assert GROUPS == 8, GROUPS
from sregex_tpu import parse_multi, compile_regex
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops.pallas_core import (CoreTables, core_count_fused,
                                        FUSED_CAP)
assert FUSED_CAP == 4096, FUSED_CAP
rng = random.Random(2)
words = list({("".join(rng.choice("abcdefghijklmn")
                       for _ in range(4))).encode()
              for _ in range(14)})
ast, _ = parse_multi(words)
dfa = build_dfa(compile_regex(ast))
try:
    full = SpecTables(dfa)
except ValueError:
    full = SpecTablesWide(dfa)
filler = [("".join(rng.choice("nopqrstuv") for _ in range(5)))
          .encode() for _ in range(12)]
piece = b" ".join(rng.choice(filler) for _ in range(64)) + b" "
n = 200_000
data = bytearray((piece * (n // len(piece) + 1))[:n])
for pos in range(8192, n - 16, 8192):
    w = words[rng.randrange(len(words))]
    data[pos:pos + len(w) + 2] = b" " + w + b" "
data = bytes(data)
ct = CoreTables(dfa, data[:64 << 10], require_fast=False)
native = NativeDfa(dfa)
exp = native.count(data, 0)
r = core_count_fused(ct, full, data, chunk_len=512)
assert r is not None, "fused declined with FUSED_CAP=4096 at G=8"
st, got = r
assert (got, st) == (exp[0], exp[1]), (got, exp)
print("G8_CAP_OK")
"""


def test_g8_fused_cap_rounds_to_block():
    """Regression (round-4 advisor, LOW): SREGEX_FUSED_CAP=4096 at
    the production G=8 must round UP to one phase-2 block (8192)
    instead of tracing B2 = 0 and declining the fused tier."""
    r = subprocess.run([sys.executable, "-c", _SCRIPT_FUSED_CAP],
                       capture_output=True, text=True, timeout=560,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert "G8_CAP_OK" in r.stdout, (r.stdout[-2000:],
                                     r.stderr[-2000:])
