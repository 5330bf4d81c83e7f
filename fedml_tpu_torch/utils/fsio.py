"""Durability primitives shared by the flight recorder's writers (the
port's copy of ``fedml_tpu/utils/fsio.py``).

``os.replace`` makes a rename atomic *in the namespace*, but the rename
itself lives in the parent directory's entry block — on a power-loss (or
an unsynced filesystem) a crash right after the replace can roll the
directory back and the published file silently vanishes. POSIX's answer
is an ``fsync`` on the *directory* file descriptor after the rename.
Process-level kills (SIGKILL) never need
it (the page cache survives the process), so every caller treats a
refused directory fsync as a degraded-durability warning, not an error:
network filesystems and some overlay mounts return ``EINVAL``/
``EBADF``/``ENOTSUP`` here and the federation must keep training.
"""

from __future__ import annotations

import logging
import os
import threading

#: directories whose fsync refusal was already warned about — the
#: degrade path logs ONCE per directory per process, not once per round
_WARNED_DIRS: set = set()
_WARNED_LOCK = threading.Lock()


def fsync_dir(directory: str) -> bool:
    """fsync the directory entry after an ``os.replace`` publish.

    Returns True when the directory fsync succeeded, False on the
    degrade-to-warning path (filesystem refused a directory fsync, or
    the platform cannot open directories read-only)."""
    fd = None
    try:
        fd = os.open(directory, os.O_RDONLY)
        os.fsync(fd)
        return True
    except OSError as exc:
        with _WARNED_LOCK:
            first = directory not in _WARNED_DIRS
            _WARNED_DIRS.add(directory)
        if first:
            logging.warning(
                "directory fsync refused for %s (%r) — renames there are "
                "atomic in the namespace but NOT power-loss durable; "
                "continuing with degraded durability", directory, exc)
        return False
    finally:
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass
