"""Storage backends for the serving engine — the fault seam.

Every byte :class:`repro_torch.serve.IndexService` serves comes through a
:class:`StorageBackend`: ``pread(nbytes, offset) -> bytes`` plus a size
probe and a close.  :class:`FileBackend` is the real thing (an ``os.pread``
that loops until the requested window is filled).
:class:`FaultInjectingBackend` wraps any backend with a deterministic,
seeded fault schedule — transient or persistent ``EIO``, torn reads, page
corruption, stalls, a flaky start — whose draws are the JAX package's
(``repro.serve.backend``), so equal seeds give an equal ``fault_log``.

The typed error ladder the engine raises once its
:class:`repro_torch.api.RetryPolicy` budget is spent:

``StorageError``
    base class;
``ReadError``
    a pread (or its finer-granularity degraded retries) kept failing;
``CorruptPageError``
    a page failed its CRC32 check twice (fetch + one refetch);
``DeadlineExceededError``
    the per-pread or per-batch deadline expired.
"""
from __future__ import annotations

import errno
import os
import threading
import time

import numpy as np


# ---------------------------------------------------------------------------
# typed failures (the serving stack's error surface)
# ---------------------------------------------------------------------------
class StorageError(Exception):
    """Base for serving-path storage failures (after retries/repairs)."""


class ReadError(StorageError):
    """A pread failed past the retry budget (EIO, short read, ...)."""

    def __init__(self, msg: str, *, path=None, offset=None, nbytes=None,
                 attempts=None):
        super().__init__(msg)
        self.path = path
        self.offset = offset
        self.nbytes = nbytes
        self.attempts = attempts


class CorruptPageError(StorageError):
    """A page failed CRC32 verification twice (fetch + one refetch)."""

    def __init__(self, msg: str, *, path=None, page_id=None):
        super().__init__(msg)
        self.path = path
        self.page_id = page_id


class DeadlineExceededError(StorageError):
    """A per-pread or per-batch RetryPolicy deadline expired."""


# ---------------------------------------------------------------------------
# the real backend
# ---------------------------------------------------------------------------
def pread_full(fd: int, nbytes: int, offset: int) -> bytes:
    """``os.pread`` that loops until ``nbytes`` arrive or EOF, so callers
    never see a transiently torn buffer."""
    # airlint: allow[pread-seam] -- this IS the port's pread seam: every
    # serving read reaches the syscall through this one helper
    buf = os.pread(fd, nbytes, offset)
    if len(buf) == nbytes or not buf:
        return buf
    parts = [buf]
    got = len(buf)
    while got < nbytes:
        # airlint: allow[pread-seam] -- the seam's short-read continuation
        chunk = os.pread(fd, nbytes - got, offset + got)
        if not chunk:          # true EOF: a legitimately short window
            break
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


class StorageBackend:
    """Minimal read-only storage surface the serving engine needs."""

    path: str | None = None

    def pread(self, nbytes: int, offset: int) -> bytes:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FileBackend(StorageBackend):
    """A local file served through short-read-safe ``os.pread``."""

    def __init__(self, path: str):
        self.path = path
        # airlint: allow[pread-seam] -- the seam's own descriptor; all reads
        # on it go through pread_full above
        self.fd: int | None = os.open(path, os.O_RDONLY)

    def pread(self, nbytes: int, offset: int) -> bytes:
        return pread_full(self.fd, int(nbytes), int(offset))

    def size(self) -> int:
        return os.fstat(self.fd).st_size

    def close(self) -> None:
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None


# ---------------------------------------------------------------------------
# deterministic fault injection (chaos harness)
# ---------------------------------------------------------------------------
class FaultInjectingBackend(StorageBackend):
    """Wrap a backend with a seeded, deterministic fault schedule.

    Whether a read window faults is a pure function of
    ``(seed, offset, nbytes)`` plus that window's attempt index, so a
    schedule replays identically regardless of thread interleaving.

    eio_rate / eio_attempts:
        selected windows raise ``OSError(EIO)`` for their first
        ``eio_attempts`` reads, then heal; ``None`` makes it persistent.
    short_rate / short_attempts:
        selected windows return a torn buffer (roughly half the bytes).
    corrupt_rate / corrupt_attempts:
        selected windows return the first byte of each page XOR 0xFF.
    stall_rate / stall_seconds / stall_attempts:
        selected windows sleep before returning good data.
    fail_first:
        the first ``fail_first`` calls (any window) raise EIO.
    only_over_bytes:
        faults apply only to reads strictly larger than this.
    only_from_offset:
        faults apply only to reads at or past this file offset.
    """

    def __init__(self, inner: StorageBackend, *, seed: int = 0,
                 eio_rate: float = 0.0, eio_attempts: int | None = 1,
                 short_rate: float = 0.0, short_attempts: int = 1,
                 corrupt_rate: float = 0.0, corrupt_attempts: int = 1,
                 stall_rate: float = 0.0, stall_seconds: float = 0.002,
                 stall_attempts: int = 1,
                 fail_first: int = 0, only_over_bytes: int = 0,
                 only_from_offset: int = 0, page_bytes: int = 4096):
        self.inner = inner
        self.path = inner.path
        self.seed = int(seed)
        self.eio_rate = float(eio_rate)
        self.eio_attempts = eio_attempts
        self.short_rate = float(short_rate)
        self.short_attempts = int(short_attempts)
        self.corrupt_rate = float(corrupt_rate)
        self.corrupt_attempts = int(corrupt_attempts)
        self.stall_rate = float(stall_rate)
        self.stall_seconds = float(stall_seconds)
        self.stall_attempts = int(stall_attempts)
        self.fail_first = int(fail_first)
        self.only_over_bytes = int(only_over_bytes)
        self.only_from_offset = int(only_from_offset)
        self.page_bytes = int(page_bytes)
        self.calls = 0
        self.fault_log: list[tuple] = []   # (kind, offset, nbytes, attempt)
        self._attempts: dict[tuple, int] = {}
        self._mu = threading.Lock()

    def _draws(self, offset: int, nbytes: int) -> np.ndarray:
        """Four uniform draws, a pure function of (seed, offset, nbytes)."""
        rng = np.random.default_rng(
            [self.seed, int(offset) & 0x7FFFFFFF, int(nbytes) & 0x7FFFFFFF])
        return rng.random(4)

    def _log(self, kind: str, offset: int, nbytes: int, attempt: int):
        self.fault_log.append((kind, int(offset), int(nbytes), attempt))

    def pread(self, nbytes: int, offset: int) -> bytes:
        with self._mu:
            call = self.calls
            self.calls += 1
            key = (int(offset), int(nbytes))
            attempt = self._attempts.get(key, 0)
            self._attempts[key] = attempt + 1
            if call < self.fail_first:
                self._log("fail_first", offset, nbytes, attempt)
        if call < self.fail_first:
            raise OSError(errno.EIO, f"injected flaky-start EIO "
                                     f"(call {call} < {self.fail_first})")
        if nbytes <= self.only_over_bytes or offset < self.only_from_offset:
            return self.inner.pread(nbytes, offset)
        u_eio, u_short, u_corrupt, u_stall = self._draws(offset, nbytes)
        if u_stall < self.stall_rate and attempt < self.stall_attempts:
            with self._mu:
                self._log("stall", offset, nbytes, attempt)
            time.sleep(self.stall_seconds)
        if u_eio < self.eio_rate and (self.eio_attempts is None
                                      or attempt < self.eio_attempts):
            with self._mu:
                self._log("eio", offset, nbytes, attempt)
            raise OSError(errno.EIO, f"injected EIO at offset {offset} "
                                     f"(attempt {attempt})")
        data = self.inner.pread(nbytes, offset)
        if u_short < self.short_rate and attempt < self.short_attempts \
                and len(data) > 1:
            with self._mu:
                self._log("short", offset, nbytes, attempt)
            return data[:len(data) // 2]
        if u_corrupt < self.corrupt_rate and attempt < self.corrupt_attempts \
                and data:
            with self._mu:
                self._log("corrupt", offset, nbytes, attempt)
            # flip the first byte of every page in the window: each torn
            # page fails its CRC, not just the window's first
            buf = bytearray(data)
            for k in range(0, len(buf), self.page_bytes):
                buf[k] ^= 0xFF
            return bytes(buf)
        return data

    def size(self) -> int:
        return self.inner.size()

    def close(self) -> None:
        self.inner.close()
