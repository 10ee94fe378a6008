"""Build-and-load of the native C++ engines (csrc/*.cpp).

Each library is compiled from the committed source into
``build/native/`` at the root of the checkout (listed in .gitignore),
under a file name keyed by the source bytes, the compiler flags and
the host (``-march=native`` code is only valid on the CPU it was
built for).  A checkout copied to another machine therefore never
loads a library built elsewhere: it builds its own on first use.

``python -m sregex_tpu.native_build`` builds all three libraries and
prints where they are.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CSRC = os.path.join(_ROOT, "csrc")

# source name -> prebuilt library path loaded instead of a build (the
# AddressSanitizer stress run, tests/asan_stress.py)
OVERRIDES = {}


def _host_key():
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    cpu += line
    except OSError:
        pass
    return "\n".join([platform.node(), platform.machine(), cpu])


def library_path(source, flags):
    """Path of the library built from csrc/``source`` with ``flags``
    on this host."""
    with open(os.path.join(CSRC, source), "rb") as f:
        src = f.read()
    h = hashlib.sha256(src)
    h.update("\0".join(flags).encode())
    h.update(_host_key().encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, "%s-%s.so" % (stem, h.hexdigest()[:16]))


def load(source, flag_variants):
    """Load the library built from csrc/``source``, building it first
    if needed.  ``flag_variants``: compiler flag lists tried in order
    (the first that compiles wins).  Raises on failure."""
    if source in OVERRIDES:
        return ctypes.CDLL(OVERRIDES[source])
    errors = []
    for flags in flag_variants:
        path = library_path(source, flags)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = (["g++"] + list(flags)
                   + ["-o", tmp, os.path.join(CSRC, source)])
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                os.unlink(tmp)
                errors.append("%s: %s" % (" ".join(cmd), r.stderr[-2000:]))
                continue
            os.replace(tmp, path)   # atomic: concurrent builders agree
        return ctypes.CDLL(path)
    raise RuntimeError("building %s failed:\n%s"
                       % (source, "\n".join(errors)))


def load_all():
    """Load (building as needed) the three engine libraries; returns
    {name: library or None}."""
    from . import native, native_pike, native_tdfa
    return {"sre_host": native.get_lib(),
            "sre_pike": native_pike.get_lib(),
            "sre_tdfa": native_tdfa.get_lib()}


if __name__ == "__main__":
    for name, lib in load_all().items():
        print(name, lib._name if lib is not None else "FAILED")
