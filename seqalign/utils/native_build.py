"""Build the native libraries from ``native/`` at first use.

Every shared library this package loads is compiled from the sources in
``native/`` by its Makefile, into paths that ``.gitignore`` lists. Builds
are serialized across processes by a file lock (pytest-xdist workers and
multi-host ranks start together), and the Makefile writes each library
under a temporary name and renames it into place, so a loader never sees
a half-written file.
"""

from __future__ import annotations

import fcntl
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
NATIVE = REPO / "native"
BUILD = REPO / "build"


def _stale(target: Path, sources: list[Path]) -> bool:
    if not target.exists():
        return True
    t = target.stat().st_mtime
    return any(s.stat().st_mtime > t for s in sources)


def make(target: Path, sources: list[Path], make_args: list[str]) -> None:
    """Run ``make -C native <make_args>`` unless ``target`` is up to date.

    Raises ``RuntimeError`` with the compiler's output when the build fails.
    """
    if not _stale(target, sources):
        return
    BUILD.mkdir(exist_ok=True)
    with open(BUILD / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(target, sources):  # another process built it
            return
        proc = subprocess.run(
            ["make", "-s", "-C", str(NATIVE), *make_args],
            capture_output=True, text=True,
        )
        if proc.returncode != 0 or not target.exists():
            raise RuntimeError(
                f"building {target.name} failed (make {' '.join(make_args)}):"
                f"\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}"
            )


def host_library(name: str) -> Path | None:
    """Path of a host C++ library (``fastio`` or ``traceback``), built on
    first use. Returns None, after saying why on stderr, when it cannot be
    built here; callers then use their pure-Python paths."""
    pkg = REPO / "seqalign"
    target = {
        "fastio": pkg / "utils" / "_fastio.so",
        "traceback": pkg / "ops" / "_traceback.so",
    }[name]
    sources = [NATIVE / f"{name}.cc", NATIVE / "Makefile"]
    try:
        make(target, sources, [str(target.relative_to(NATIVE, walk_up=True))])
    except (RuntimeError, OSError) as e:
        import sys

        print(f"Warning: native {name} unavailable ({e})", file=sys.stderr)
        return None
    return target
