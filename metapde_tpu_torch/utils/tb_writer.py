"""TensorBoard event writer (counterpart of metapde_tpu/utils/tb_writer.py):
a native record core, native/tb_writer.cpp through ctypes, and a pure-Python
writer that emits the same bytes.

The native core is compiled at first use by the host C++ compiler ($CXX,
else g++ or c++) into ``build/tb_writer/`` at the repository root, named by
a hash of the source, the flags, the compiler's version and the machine
(so a tree copied to another machine builds its own), and never at import; the committed
native/libtbwriter.so, a prebuilt binary, is not loaded. Where no
compiler is found or the build fails, the writer takes the Python path.

Formats: TFRecord framing (u64-LE length, masked CRC32C of the length, the
payload, masked CRC32C of the payload) around tensorflow.Event / Summary
protobufs, encoded by hand for scalars and histograms. Standard TensorBoard
reads the files.
"""

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import struct
import subprocess
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "tb_writer.cpp"
BUILD_DIR = REPO / "build" / "tb_writer"
CXX_FLAGS = ("-O2", "-fPIC", "-Wall", "-std=c++17", "-shared")


def _compiler():
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def _build():
    """The native core's library path, compiled if missing; None without a
    compiler or when the compile fails."""
    cxx = _compiler()
    if cxx is None or not SOURCE.exists():
        return None
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + version
                            + platform.platform().encode()).hexdigest()
    out = BUILD_DIR / f"libtbwriter_{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, timeout=120)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def _load_native():
    """The native core through ctypes, once per process; None when it
    cannot be built or loaded."""
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.tbw_open.restype = ctypes.c_void_p
    lib.tbw_open.argtypes = [ctypes.c_char_p, ctypes.c_double]
    lib.tbw_scalar.restype = None
    lib.tbw_scalar.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_float, ctypes.c_double]
    lib.tbw_histogram.restype = None
    lib.tbw_histogram.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double,
    ]
    lib.tbw_close.restype = None
    lib.tbw_close.argtypes = [ctypes.c_void_p]
    return lib


# ------------------------------------------------------------ Python path
@functools.lru_cache(maxsize=None)
def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
        table.append(c)
    return table


def _crc32c(data: bytes) -> int:
    table, c = _crc_table(), 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(v: int) -> bytes:
    out = b""
    while v >= 0x80:
        out += bytes([(v & 0x7F) | 0x80])
        v >>= 7
    return out + bytes([v])


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field, v):
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field, v):
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field, v):
    return _tag(field, 0) + _varint(v)


def _pb_bytes(field, v: bytes):
    return _tag(field, 2) + _varint(len(v)) + v


def _encode_event(wall_time, step=None, file_version=None, summary=None):
    """Event: wall_time = 1, step = 2, file_version = 3, summary = 5."""
    e = _pb_double(1, wall_time)
    if step is not None:
        e += _pb_int64(2, step)
    if file_version is not None:
        e += _pb_bytes(3, file_version.encode())
    if summary is not None:
        e += _pb_bytes(5, summary)
    return e


def _scalar_summary(tag, value):
    return _pb_bytes(1, _pb_bytes(1, tag.encode()) + _pb_float(2, value))


def _histo_summary(tag, limits, counts, mn, mx, num, total, total_sq):
    h = (_pb_double(1, mn) + _pb_double(2, mx) + _pb_double(3, num)
         + _pb_double(4, total) + _pb_double(5, total_sq))
    h += _pb_bytes(6, struct.pack(f"<{len(limits)}d", *limits))
    h += _pb_bytes(7, struct.pack(f"<{len(counts)}d", *counts))
    return _pb_bytes(1, _pb_bytes(1, tag.encode()) + _pb_bytes(5, h))


def record(payload: bytes) -> bytes:
    """One TFRecord around `payload`."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


class EventWriter:
    """Writes one TensorBoard event file under `logdir`: through the native
    core when it builds (prefer_native), else in Python."""

    def __init__(self, logdir: str, prefer_native: bool = True):
        os.makedirs(logdir, exist_ok=True)
        fname = os.path.join(logdir, f"events.out.tfevents.{int(time.time())}.metapde")
        self._lib = _load_native() if prefer_native else None
        self._f = None
        if self._lib is not None:
            self._handle = self._lib.tbw_open(fname.encode(), time.time())
            if not self._handle:
                self._lib = None
        if self._lib is None:
            self._f = open(fname, "wb")
            self._write_record(_encode_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, payload: bytes):
        self._f.write(record(payload))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int):
        if self._lib is not None:
            self._lib.tbw_scalar(self._handle, tag.encode(), step, float(value), time.time())
        else:
            self._write_record(_encode_event(time.time(), step,
                                             summary=_scalar_summary(tag, float(value))))

    def histogram(self, tag: str, values, step: int, bins: int = 30):
        values = np.asarray(values, np.float64).reshape(-1)
        if values.size == 0:
            return
        counts, edges = np.histogram(values, bins=bins)
        limits, counts = edges[1:].tolist(), counts.astype(np.float64).tolist()
        stats = (float(values.min()), float(values.max()), float(values.size),
                 float(values.sum()), float((values ** 2).sum()))
        if self._lib is not None:
            n = len(limits)
            self._lib.tbw_histogram(self._handle, tag.encode(), step,
                                    (ctypes.c_double * n)(*limits),
                                    (ctypes.c_double * n)(*counts), n, *stats, time.time())
        else:
            self._write_record(_encode_event(time.time(), step,
                                             summary=_histo_summary(tag, limits, counts, *stats)))

    def close(self):
        if self._lib is not None:
            self._lib.tbw_close(self._handle)
            self._lib = None
        elif self._f is not None:
            self._f.close()
            self._f = None


def _fields(buf: bytes):
    """(field, wire type, value) of a protobuf message: ints for varints,
    bytes for 64-bit, 32-bit and length-delimited fields."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, v


def _read_varint(buf, i):
    shift = v = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            return v, i


def read_records(fname):
    """The payloads of a TFRecord file; raises ValueError on a bad CRC or a
    truncated record."""
    data, i, out = Path(fname).read_bytes(), 0, []
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"truncated record header at byte {i}")
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        payload = data[i + 12:i + 12 + n]
        if crc != _masked_crc(header) or len(payload) != n or i + 16 + n > len(data):
            raise ValueError(f"bad record header at byte {i}")
        (crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != _masked_crc(payload):
            raise ValueError(f"bad payload CRC at byte {i}")
        out.append(payload)
        i += 16 + n
    return out


def read_scalars(fname):
    """[(step, tag, value)] of the scalar summaries of an event file, in
    file order, the CRCs checked."""
    out = []
    for payload in read_records(fname):
        ev = {f: v for f, _, v in _fields(payload)}
        if 5 not in ev:
            continue
        for f, _, value in _fields(ev[5]):
            if f != 1:
                continue
            val = {vf: vv for vf, _, vv in _fields(value)}
            if 2 in val:
                out.append((ev.get(2, 0), val[1].decode(), struct.unpack("<f", val[2])[0]))
    return out
