"""Scan observability: per-scan stats records and loud degradation.

The reference's only introspection is the per-TU ``dd()`` trace macro
(ddebug.h:13-26).  An accelerator framework deserves more: all the adaptive
policy lives in the device dispatch (tier selection, chunk
speculation, escape repair, re-coring), and a production operator
needs to see which path served a scan and how much of it had to be
repaired natively — silent degradation is indistinguishable from
normal operation otherwise.

Two facilities:

- ``ScanStats``: one record per completed high-level scan
  (Scanner.match/count/scan/*_stream), exposed via
  ``Scanner.stats()``.  Fields: the API called, the tier that served
  it, corpus bytes, kernel chunk count, natively repaired chunks,
  cumulative re-core events, and wall-clock ms.

- ``degraded(key, msg)``: called where the scan API deliberately
  swallows a device failure and falls back to the host engines.
  Default: warn ONCE per key (RuntimeWarning) so a broken device
  stack is visible without spamming per-scan.  With
  ``SREGEX_STRICT_DEVICE=1`` it raises instead — production serving
  where host-rate fallback is an outage, not a convenience.
"""

import os
import warnings


class ScanStats:
    """One completed scan's record (see module docstring)."""

    __slots__ = ("api", "tier", "nbytes", "chunks", "repaired",
                 "recore_events", "warm_events", "elapsed_ms")

    def __init__(self, api, tier, nbytes, chunks=0, repaired=0,
                 recore_events=0, warm_events=0, elapsed_ms=0.0):
        self.api = api
        self.tier = tier
        self.nbytes = nbytes
        self.chunks = chunks
        self.repaired = repaired
        self.recore_events = recore_events
        self.warm_events = warm_events
        self.elapsed_ms = elapsed_ms

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return ("ScanStats(" + ", ".join(
            f"{k}={getattr(self, k)!r}" for k in self.__slots__) + ")")


def strict_device():
    return os.environ.get("SREGEX_STRICT_DEVICE") == "1"


_warned = set()


def reset_warned():
    """Test hook: re-arm the warn-once latch."""
    _warned.clear()


def degraded(key, msg):
    """Record a silent-degradation event: the device path failed and
    the scan API is about to fall back to the host engines.  Warns
    once per ``key``; raises under SREGEX_STRICT_DEVICE=1."""
    if strict_device():
        raise RuntimeError(
            f"sregex-tpu device degradation (SREGEX_STRICT_DEVICE=1): "
            f"{msg}")
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(
        f"sregex-tpu: {msg} — falling back to the host engines "
        f"(set SREGEX_STRICT_DEVICE=1 to make this an error)",
        RuntimeWarning, stacklevel=3)
