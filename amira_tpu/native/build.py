"""Build the native host-runtime extension (_fastio) in place.

Compiles amira_tpu/native/_fastio.c with the system toolchain on first
import; amira_tpu.native.load() returns the module or None (callers fall
back to the pure-Python implementations)."""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "_fastio.c")


def _so_path() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_DIR, "_fastio" + suffix)


def build(force: bool = False) -> str | None:
    so = _so_path()
    if (
        not force
        and os.path.exists(so)
        and os.path.getmtime(so) >= os.path.getmtime(_SRC)
    ):
        return so
    include = sysconfig.get_paths()["include"]
    cc = os.environ.get("CC", "gcc")
    # compile to a private name and rename into place, so concurrent first
    # imports (test workers, batch streams) never load a half-written file
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        cc, "-O2", "-fPIC", "-shared", "-o", tmp, _SRC,
        f"-I{include}", "-lz",
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, text=True, timeout=120
        )
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        sys.stderr.write(f"amira-tpu: native build failed ({e}); using Python fallbacks\n")
        return None
    os.replace(tmp, so)
    return so


_module = None
_tried = False


def load():
    global _module, _tried
    if _tried:
        return _module
    _tried = True
    if os.environ.get("AMIRA_TPU_NO_NATIVE"):
        return None
    if build() is None:
        return None
    try:
        from amira_tpu.native import _fastio  # type: ignore

        _module = _fastio
    except ImportError:
        _module = None
    return _module
