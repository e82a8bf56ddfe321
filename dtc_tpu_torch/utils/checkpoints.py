"""Crash-safe sweep journal.

A copy of ``dtc_tpu/utils/checkpoints.py`` (``SweepJournal``) and of the
pure-Python journal format of ``dtc_tpu/native/__init__.py``
(``journal_append``, ``journal_read``); the port loads no C library of the
JAX package. A journal is a file of records

    b"DTCJ" | <IQI: key length, payload length, CRC32 of the payload> | key
    | payload

each payload one numpy array in ``.npy`` form. Reading stops at the first
torn or corrupt record, so a sweep killed mid-write resumes from its last
whole record. Files are interchangeable with the reference's.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

_MAGIC = b"DTCJ"
_HEADER = struct.Struct("<IQI")


def journal_append(path: str, key: str, data: bytes) -> None:
    """Append one record and flush it to the file."""
    k = key.encode()
    with open(path, "ab") as f:
        f.write(_MAGIC)
        f.write(_HEADER.pack(len(k), len(data), zlib.crc32(data) & 0xFFFFFFFF))
        f.write(k)
        f.write(data)
        f.flush()


def journal_read(path: str) -> list:
    """(key, data) records up to the first torn or corrupt one."""
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        blob = f.read()
    out = []
    off = 0
    head = len(_MAGIC) + _HEADER.size
    while off + head <= len(blob):
        if blob[off:off + len(_MAGIC)] != _MAGIC:
            break
        keylen, datalen, crc = _HEADER.unpack_from(blob, off + len(_MAGIC))
        start = off + head
        end = start + keylen + datalen
        if end > len(blob):
            break
        data = blob[start + keylen:end]
        if (zlib.crc32(data) & 0xFFFFFFFF) != crc:
            break
        out.append((blob[start:start + keylen].decode(errors="replace"),
                    data))
        off = end
    return out


class SweepJournal:
    """Append-only store of named numpy arrays with crash-safe resume."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._done: dict[str, np.ndarray] = {}
        for key, blob in journal_read(path):
            self._done[key] = self._decode(blob)

    @staticmethod
    def _encode(arr) -> bytes:
        buf = io.BytesIO()
        np.save(buf, np.asarray(arr), allow_pickle=False)
        return buf.getvalue()

    @staticmethod
    def _decode(blob: bytes) -> np.ndarray:
        return np.load(io.BytesIO(blob), allow_pickle=False)

    def __contains__(self, key: str) -> bool:
        return key in self._done

    def get(self, key: str):
        return self._done.get(key)

    def put(self, key: str, arr) -> None:
        journal_append(self.path, key, self._encode(arr))
        self._done[key] = np.asarray(arr)

    def keys(self) -> list:
        return list(self._done)
