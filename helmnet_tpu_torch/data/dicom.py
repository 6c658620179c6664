"""Minimal DICOM CT ingestion for the skull pipeline; the port's own copy
of `helmnet_tpu/data/dicom.py` (numpy only; files either package writes
read back the same in both).

Counterpart of the reference's `dicomread` usage (skull_example.m:11-13:
read a CT slice, apply the rescale to Hounsfield units, feed skull2medium).
Uses pydicom when installed; otherwise falls back to a small built-in
parser that handles the common CT export formats — uncompressed little-
endian DICOM, both Explicit VR (1.2.840.10008.1.2.1) and Implicit VR
(1.2.840.10008.1.2) transfer syntaxes. Compressed/ big-endian syntaxes
raise with a clear message.

Output is always Hounsfield units as float64:
HU = RescaleSlope * stored + RescaleIntercept.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np

_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_IMPLICIT_LE = "1.2.840.10008.1.2"
# VRs whose explicit encoding uses a 2-byte reserved field + 4-byte length
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT",
             b"UN"}

_TAGS = {
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
    (0x0020, 0x0013): "InstanceNumber",
    (0x7FE0, 0x0010): "PixelData",
}


def _skip_undefined_sequence(buf: bytes, pos: int) -> int:
    """Advance past an undefined-length (0xFFFFFFFF) sequence by scanning
    for its Sequence Delimitation Item (FFFE,E0DD)."""
    end = buf.find(b"\xfe\xff\xdd\xe0", pos)
    if end < 0:
        raise ValueError("unterminated undefined-length DICOM sequence")
    return end + 8  # tag (4) + zero length (4)


def _parse_elements(buf: bytes, pos: int, explicit: bool) -> Dict[str, object]:
    out: Dict[str, object] = {}
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        vr = b""
        if explicit and group != 0xFFFE:
            vr = buf[pos : pos + 2]
            if vr in _LONG_VRS:
                (length,) = struct.unpack_from("<I", buf, pos + 4)
                pos += 8
            else:
                (length,) = struct.unpack_from("<H", buf, pos + 2)
                pos += 4
        else:
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4
        if length == 0xFFFFFFFF:
            pos = _skip_undefined_sequence(buf, pos)
            continue
        value = buf[pos : pos + length]
        pos += length
        name = _TAGS.get((group, elem))
        if name is None:
            continue
        if name in ("Rows", "Columns", "BitsAllocated", "PixelRepresentation"):
            out[name] = struct.unpack("<H", value[:2])[0]
        elif name in ("RescaleIntercept", "RescaleSlope", "InstanceNumber"):
            try:
                out[name] = float(value.decode("ascii").strip("\x00 "))
            except ValueError:
                pass
        else:  # PixelData
            out[name] = value
        if name == "PixelData":
            break
    return out


def _read_builtin(path: str) -> Dict[str, object]:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[128:132] != b"DICM":
        raise ValueError(f"{path}: missing DICM magic (not a Part-10 file)")
    # file meta group (0002) is always explicit VR little endian; find the
    # transfer syntax and the end of the meta group
    pos = 132
    syntax = _EXPLICIT_LE
    while pos + 8 <= len(buf):
        group, elem = struct.unpack_from("<HH", buf, pos)
        if group != 0x0002:
            break
        vr = buf[pos + 4 : pos + 6]
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from("<I", buf, pos + 8)
            header = 12
        else:
            (length,) = struct.unpack_from("<H", buf, pos + 6)
            header = 8
        if (group, elem) == (0x0002, 0x0010):
            syntax = (
                buf[pos + header : pos + header + length]
                .decode("ascii")
                .strip("\x00 ")
            )
        pos += header + length
    if syntax not in (_EXPLICIT_LE, _IMPLICIT_LE):
        raise ValueError(
            f"{path}: unsupported transfer syntax {syntax!r} "
            "(only uncompressed little-endian; install pydicom for others)"
        )
    return _parse_elements(buf, pos, explicit=syntax == _EXPLICIT_LE)


def read_dicom_hu(path: str) -> np.ndarray:
    """Read one CT slice -> Hounsfield units [Rows, Columns] float64.

    pydicom (if installed) handles any transfer syntax; the built-in parser
    covers uncompressed little-endian files.
    """
    try:
        import pydicom  # optional dependency

        ds = pydicom.dcmread(path)
        raw = ds.pixel_array.astype(np.float64)
        slope = float(getattr(ds, "RescaleSlope", 1.0))
        intercept = float(getattr(ds, "RescaleIntercept", 0.0))
        return slope * raw + intercept
    except ImportError:
        pass
    el = _read_builtin(path)
    for req in ("Rows", "Columns", "BitsAllocated", "PixelData"):
        if req not in el:
            raise ValueError(f"{path}: missing required DICOM element {req}")
    bits = el["BitsAllocated"]
    if bits not in (8, 16):
        raise ValueError(f"{path}: unsupported BitsAllocated {bits}")
    signed = el.get("PixelRepresentation", 0) == 1
    dtype = {8: np.int8 if signed else np.uint8,
             16: np.int16 if signed else np.uint16}[bits]
    rows, cols = el["Rows"], el["Columns"]
    raw = np.frombuffer(el["PixelData"], dtype=dtype)[: rows * cols]
    raw = raw.reshape(rows, cols).astype(np.float64)
    return el.get("RescaleSlope", 1.0) * raw + el.get("RescaleIntercept", 0.0)


def load_ct_series(directory: str) -> np.ndarray:
    """Read every .dcm slice in a directory -> [slices, Rows, Columns] HU,
    ordered by InstanceNumber when present (filename order otherwise)."""
    paths = sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.lower().endswith(".dcm")
    )
    if not paths:
        raise FileNotFoundError(f"no .dcm files in {directory}")
    slices = []
    for p in paths:
        order = None
        try:
            order = _read_builtin(p).get("InstanceNumber")
        except ValueError:
            pass
        slices.append((order if order is not None else len(slices), read_dicom_hu(p)))
    slices.sort(key=lambda t: t[0])
    return np.stack([s for _, s in slices])


def write_dicom_ct(path: str, hu: np.ndarray, slope: float = 1.0,
                   intercept: float = -1024.0, instance: int = 1) -> None:
    """Write a minimal Explicit-VR little-endian CT slice (round-trip
    utility for tests and for exporting synthetic phantoms)."""
    hu = np.asarray(hu, np.float64)
    stored = np.round((hu - intercept) / slope).astype(np.int16)

    def elem(group, el, vr, value: bytes) -> bytes:
        if len(value) % 2:
            value += b"\x00" if vr != b"DS" else b" "
        head = struct.pack("<HH", group, el) + vr
        if vr in _LONG_VRS:
            return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
        return head + struct.pack("<H", len(value)) + value

    meta = elem(0x0002, 0x0010, b"UI", _EXPLICIT_LE.encode())
    body = b"".join(
        [
            elem(0x0020, 0x0013, b"IS", str(instance).encode()),
            elem(0x0028, 0x0010, b"US", struct.pack("<H", hu.shape[0])),
            elem(0x0028, 0x0011, b"US", struct.pack("<H", hu.shape[1])),
            elem(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
            elem(0x0028, 0x0103, b"US", struct.pack("<H", 1)),
            elem(0x0028, 0x1052, b"DS", repr(float(intercept)).encode()),
            elem(0x0028, 0x1053, b"DS", repr(float(slope)).encode()),
            elem(0x7FE0, 0x0010, b"OW", stored.astype("<i2").tobytes()),
        ]
    )
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)
