"""The routed transport's native broker, loaded through ctypes (the port's
counterpart of ``fedml_tpu/native/__init__.py``).

``router.cpp`` beside this file is a star-topology frame router that silos
dial out to, with frames addressed by rank (the NAT-friendly topology of
the reference's MQTT path). Python drives it through :class:`NativeRouter`,
and ranks reach it through ``comm/routed.py``'s ``RoutedCommManager``.

The shared library is built with g++ (``-O2 -std=c++17 -fPIC -shared
-pthread``) at first use into ``fedml_tpu_torch/_build/`` and rebuilt when
the source is newer. Every failure (no g++, a compile error, an unwritable
build directory) raises :class:`NativeUnavailable`: nothing falls back to
another transport. Unlike the JAX package's builder, this one reads its
source from the port's own tree only, builds nothing else (the JAX
package's native packer is not on the port's path) and writes nowhere
outside the package: a build goes to a temporary name and is renamed into
place, so concurrent builders never load a half-written library.

``router.cpp`` differs from the JAX package's ``native/router.cpp`` in two
fixes: it includes the headers of every standard name it uses (GCC 13's
``<condition_variable>`` no longer brings in ``<string>``), and a
connection whose HELLO registers after ``Stop()`` swept the open clients is
shut down at registration, where the original leaves its reader blocked
and ``Stop()`` waiting for it forever.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parent
SRC = _PKG_DIR / "router.cpp"
BUILD_DIR = _PKG_DIR.parent / "_build"
LIB = BUILD_DIR / "libfedml_router.so"
#: the compiler; a test points it at a missing binary
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_build_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    """The native router could not be built or loaded."""


def build_lib(src: Path = SRC, lib: Path = LIB, force: bool = False) -> Path:
    """Compile ``src`` into the shared library ``lib`` unless ``lib`` is at
    least as new as ``src``; returns ``lib``."""
    with _build_lock:
        if not src.exists():
            raise NativeUnavailable(f"native source missing: {src}")
        if (not force and lib.exists()
                and lib.stat().st_mtime >= src.stat().st_mtime):
            return lib
        try:
            lib.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=lib.parent, suffix=".so.tmp")
            os.close(fd)
        except OSError as exc:
            raise NativeUnavailable(
                f"build directory {lib.parent} is not writable: {exc}") \
                from exc
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise NativeUnavailable(
                    f"{CXX} failed to build {src.name}:\n"
                    f"{proc.stderr[-4000:]}")
            os.replace(tmp, lib)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise NativeUnavailable(
                f"{CXX} could not build {src.name}: {exc}") from exc
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return lib


def load_lib() -> ctypes.CDLL:
    """The router library, built on the first call and bound once."""
    global _lib_handle
    if _lib_handle is not None:
        return _lib_handle
    lib = ctypes.CDLL(str(build_lib()))
    lib.fedml_router_start.restype = ctypes.c_void_p
    # the token is (pointer, length), so binary secrets with NUL bytes
    # survive
    lib.fedml_router_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.fedml_router_stop.restype = None
    lib.fedml_router_stop.argtypes = [ctypes.c_void_p]
    lib.fedml_router_port.restype = ctypes.c_int
    lib.fedml_router_port.argtypes = [ctypes.c_void_p]
    lib.fedml_router_frames_routed.restype = ctypes.c_ulonglong
    lib.fedml_router_frames_routed.argtypes = [ctypes.c_void_p]
    lib.fedml_router_bytes_routed.restype = ctypes.c_ulonglong
    lib.fedml_router_bytes_routed.argtypes = [ctypes.c_void_p]
    lib.fedml_router_connected_ranks.restype = ctypes.c_int
    lib.fedml_router_connected_ranks.argtypes = [ctypes.c_void_p]
    _lib_handle = lib
    return lib


class NativeRouter:
    """One broker instance inside this process (it is silo-agnostic:
    payloads are opaque bytes). ``token``: the shared secret every silo
    must present in its HELLO; None or empty makes an open router, for
    trusted networks only (see the security note in router.cpp)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token: Optional[bytes] = None):
        lib = load_lib()
        out_port = ctypes.c_int(-1)
        tok = bytes(token) if token else b""
        self._handle = lib.fedml_router_start(host.encode(), port, tok,
                                              len(tok),
                                              ctypes.byref(out_port))
        if not self._handle:
            raise NativeUnavailable(f"router failed to bind {host}:{port}")
        self._lib = lib
        self.host = host
        self.port = out_port.value

    @property
    def frames_routed(self) -> int:
        return int(self._lib.fedml_router_frames_routed(self._handle))

    @property
    def bytes_routed(self) -> int:
        return int(self._lib.fedml_router_bytes_routed(self._handle))

    @property
    def connected_ranks(self) -> int:
        return int(self._lib.fedml_router_connected_ranks(self._handle))

    def stop(self) -> None:
        if self._handle:
            self._lib.fedml_router_stop(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
