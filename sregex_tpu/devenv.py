"""Run-environment helpers shared by bench.py and chip_smoke.py: the
persistent compile cache, the accelerator check, and the card line."""

import os
import subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache():
    """Persistent JAX compile cache: JAX_COMPILATION_CACHE_DIR when set
    (JAX reads it itself; nothing else is set), else ``.jax_cache/``
    at the root of the checkout (a fixed path, listed in .gitignore).
    Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def accelerator():
    """(platform, device_kind, count) of JAX's default devices; raises
    SystemExit when JAX found no accelerator."""
    import jax
    devs = jax.devices()
    if devs[0].platform == "cpu":
        raise SystemExit("no accelerator: JAX runs on %s"
                         % devs[0].platform)
    return devs[0].platform, devs[0].device_kind, len(devs)


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip()
