"""Minimal native E57 (ASTM E2807) point-cloud reader/writer.

A host copy of `alicevision_tpu/image/e57.py` (numpy only; `write_e57`
writes the JAX package's bytes). The reference imports lidar scans through libE57Format
(ref: src/aliceVision/dataio/E57Reader.hpp, gated by
ALICEVISION_HAVE_LIBE57FORMAT; consumed by
software/pipeline/main_lidarMerging.cpp). This module implements the
format natively so `importE57` works without the external library:

  * physical file = 1024-byte pages, each ending in a CRC-32C checksum of
    its first 1020 bytes; all offsets below are PHYSICAL, payload is the
    concatenated logical stream;
  * 48-byte header: "ASTM-E57" magic, version, physical length, XML
    physical offset/logical length, page size;
  * an XML document describes the element tree; Data3D point records live
    in CompressedVector binary sections (sectionId 1): a 32-byte section
    header followed by data packets (type 1), each carrying per-field
    bytestreams of bit-packed values.

Supported prototype field types: Float (single/double), ScaledInteger,
and Integer — which covers cartesian{X,Y,Z}, intensity and color fields
of real scanner output. The writer emits double Floats (byte-aligned),
one data packet per chunk, and is used for round-trip tests plus
`exportE57`-style interop.
"""

from __future__ import annotations

import struct
import xml.etree.ElementTree as ET

import numpy as np

PAGE = 1024
PAYLOAD = PAGE - 4
_MAGIC = b"ASTM-E57"
_NS = "http://www.astm.org/COMMIT/E57/2010-e57-v1.0"


# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        tbl = np.zeros(256, np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if (c & 1) else (c >> 1)
            tbl[i] = c
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tbl = _crc32c_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return int(c ^ 0xFFFFFFFF)


def _crc32c_pages(buf: np.ndarray) -> np.ndarray:
    """Vectorized CRC-32C over rows of a (n, PAYLOAD) uint8 array."""
    tbl = _crc32c_table()
    c = np.full(buf.shape[0], 0xFFFFFFFF, np.uint32)
    for k in range(buf.shape[1]):
        c = tbl[(c ^ buf[:, k]) & 0xFF] ^ (c >> np.uint32(8))
    return c ^ np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# physical <-> logical
# ---------------------------------------------------------------------------


def _to_logical(raw: bytes) -> bytes:
    n_pages = len(raw) // PAGE
    arr = np.frombuffer(raw[: n_pages * PAGE], np.uint8).reshape(n_pages, PAGE)
    return arr[:, :PAYLOAD].tobytes()


def _phys_to_log(off: int) -> int:
    return (off // PAGE) * PAYLOAD + min(off % PAGE, PAYLOAD)


def _log_to_phys(off: int) -> int:
    return (off // PAYLOAD) * PAGE + off % PAYLOAD


def _paginate(logical: bytes) -> bytes:
    pad = (-len(logical)) % PAYLOAD
    logical = logical + b"\0" * pad
    arr = np.frombuffer(logical, np.uint8).reshape(-1, PAYLOAD)
    crc = _crc32c_pages(arr)
    out = np.zeros((arr.shape[0], PAGE), np.uint8)
    out[:, :PAYLOAD] = arr
    out[:, PAYLOAD:] = crc.astype("<u4").view(np.uint8).reshape(-1, 4)
    return out.tobytes()


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _tag(el):
    return el.tag.split("}")[-1]


class _Field:
    def __init__(self, el):
        self.name = _tag(el)
        t = el.get("type")
        self.type = t
        if t == "Float":
            self.precision = el.get("precision", "double")
            self.bits = 32 if self.precision == "single" else 64
        elif t in ("ScaledInteger", "Integer"):
            self.minimum = int(el.get("minimum", "0"))
            self.maximum = int(el.get("maximum", "0"))
            self.scale = float(el.get("scale", "1.0"))
            self.offset = float(el.get("offset", "0.0"))
            rng = max(self.maximum - self.minimum, 0)
            self.bits = max(rng.bit_length(), 1)
        else:
            raise ValueError(f"unsupported E57 field type {t} for {self.name}")

    def decode(self, bitstream: np.ndarray, count: int, start_bit: int = 0):
        """Decode `count` values from a uint8 array of packed bits (LSB-first
        within bytes, per the E57 spec)."""
        if self.type == "Float":
            dt = "<f4" if self.bits == 32 else "<f8"
            nbytes = count * self.bits // 8
            assert start_bit % 8 == 0
            b0 = start_bit // 8
            return np.frombuffer(
                bitstream[b0 : b0 + nbytes].tobytes(), dt
            ).astype(np.float64)
        bits = np.unpackbits(bitstream, bitorder="little")
        idx = start_bit + np.arange(count)[:, None] * self.bits + np.arange(self.bits)[None, :]
        vals = (bits[idx].astype(np.uint64) << np.arange(self.bits, dtype=np.uint64)[None, :]).sum(1)
        raw = vals.astype(np.int64) + self.minimum
        if self.type == "ScaledInteger":
            return raw * self.scale + self.offset
        return raw.astype(np.float64)


def read_e57(path: str) -> dict:
    """Read an E57 file -> {"points": (N, 3) float64, "intensity": ...,
    "color": (N, 3) or None, "pose": (R (3,3), t (3,)) or None, "xml": str}
    for each scan, returned as a list under "scans" plus merged "points"."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != _MAGIC:
        raise ValueError("not an E57 file (bad magic)")
    (xml_phys_off,) = struct.unpack_from("<Q", raw, 24)
    (xml_log_len,) = struct.unpack_from("<Q", raw, 32)
    logical = _to_logical(raw)
    xml_log_off = _phys_to_log(xml_phys_off)
    xml = logical[xml_log_off : xml_log_off + xml_log_len].decode("utf-8")
    root = ET.fromstring(xml)

    def find(el, name):
        for ch in el:
            if _tag(ch) == name:
                return ch
        return None

    data3d = find(root, "data3D")
    scans = []
    all_pts = []
    for scan_el in (data3d if data3d is not None else []):
        points_el = find(scan_el, "points")
        if points_el is None:
            continue
        rec_count = int(points_el.get("recordCount", "0"))
        file_off = int(points_el.get("fileOffset", "0"))
        proto = find(points_el, "prototype")
        fields = [_Field(ch) for ch in proto]

        # CompressedVector binary section header (32 bytes logical):
        # sectionId u8, reserved[7], sectionLogicalLength u64,
        # dataPhysicalOffset u64, indexPhysicalOffset u64
        sec = _phys_to_log(file_off)
        section_id = logical[sec]
        if section_id != 1:
            raise ValueError(f"expected CompressedVector section, got {section_id}")
        (data_phys_off,) = struct.unpack_from("<Q", logical, sec + 16)
        pos = _phys_to_log(data_phys_off)

        # bytestreams are CONTINUOUS across packets (bit-packed values may
        # span packet boundaries) — accumulate bytes per field, decode once.
        per_field = [bytearray() for _ in fields]

        def have_all():
            return all(
                len(per_field[fi]) * 8 >= rec_count * f.bits
                for fi, f in enumerate(fields)
            )

        while rec_count and not have_all():
            ptype = logical[pos]
            (plen_m1,) = struct.unpack_from("<H", logical, pos + 2)
            if ptype == 1:  # data packet
                (n_streams,) = struct.unpack_from("<H", logical, pos + 4)
                if n_streams != len(fields):
                    raise ValueError("bytestream count != prototype fields")
                counts = struct.unpack_from(f"<{n_streams}H", logical, pos + 6)
                dpos = pos + 6 + 2 * n_streams
                for fi in range(n_streams):
                    per_field[fi] += logical[dpos : dpos + counts[fi]]
                    dpos += counts[fi]
            elif ptype not in (0, 2):  # 0 = index, 2 = empty: skip
                raise ValueError(f"unknown packet type {ptype}")
            pos += plen_m1 + 1

        cols = {}
        for fi, f in enumerate(fields):
            data = np.frombuffer(bytes(per_field[fi]), np.uint8)
            cols[f.name] = (
                f.decode(data, rec_count) if rec_count else np.zeros(0)
            )
        pts = np.stack(
            [cols.get(k, np.zeros(rec_count)) for k in
             ("cartesianX", "cartesianY", "cartesianZ")], 1
        )

        # rigid-body pose of the scan, applied like the reference's reader
        pose_el = find(scan_el, "pose")
        pose = None
        if pose_el is not None:
            rot = find(pose_el, "rotation")
            tr = find(pose_el, "translation")
            q = [float(find(rot, k).text) for k in ("w", "x", "y", "z")] if rot is not None else [1, 0, 0, 0]
            t = np.array(
                [float(find(tr, k).text) for k in ("x", "y", "z")]
            ) if tr is not None else np.zeros(3)
            w, x, y, z = q
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ])
            pose = (R, t)
            pts = pts @ R.T + t

        color = None
        if "colorRed" in cols:
            color = np.stack(
                [cols["colorRed"], cols["colorGreen"], cols["colorBlue"]], 1
            )
        scans.append({
            "points": pts,
            "intensity": cols.get("intensity"),
            "color": color,
            "pose": pose,
        })
        all_pts.append(pts)

    return {
        "scans": scans,
        "points": np.concatenate(all_pts) if all_pts else np.zeros((0, 3)),
        "xml": xml,
    }


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def write_e57(
    path: str,
    points: np.ndarray,  # (N, 3)
    intensity: np.ndarray | None = None,
    pose: tuple | None = None,  # (quaternion wxyz, translation xyz)
    chunk: int = 10000,
) -> None:
    """Write a single-scan E57 file with double-Float cartesian fields."""
    points = np.asarray(points, np.float64)
    n = len(points)
    fields = ["cartesianX", "cartesianY", "cartesianZ"]
    cols = [points[:, 0], points[:, 1], points[:, 2]]
    if intensity is not None:
        fields.append("intensity")
        cols.append(np.asarray(intensity, np.float64))

    # --- binary section (logical bytes) ---
    # data packets limited to 64KB logical; with F doubles/record:
    per_rec = 8 * len(fields)
    max_per_packet = min(chunk, (0xFFFF - 64) // per_rec)
    body = bytearray()
    off = 0
    packets = []
    while off < n or (n == 0 and not packets):
        take = min(max_per_packet, n - off) if n else 0
        streams = [c[off : off + take].astype("<f8").tobytes() for c in cols]
        # type, flags, logicalLengthMinus1 (patched below), bytestreamCount
        head = struct.pack("<BBHH", 1, 0, 0, len(fields))
        counts = struct.pack(f"<{len(fields)}H", *[len(s) for s in streams])
        pkt = bytearray(head + counts)
        if len(pkt) % 2:
            pkt += b"\0"
        for s in streams:
            pkt += s
        if len(pkt) % 4:
            pkt += b"\0" * (4 - len(pkt) % 4)
        struct.pack_into("<H", pkt, 2, len(pkt) - 1)
        packets.append(bytes(pkt))
        off += take
        if n == 0:
            break
    data = b"".join(packets)
    # section header (32 bytes)
    sec_len = 32 + len(data)
    section = struct.pack("<B7xQQQ", 1, sec_len, 0, 0)  # offsets patched later

    # logical layout: [48-byte header][binary section][xml]
    header_log = 48  # header occupies the first 48 logical bytes
    sec_log_off = header_log
    data_log_off = sec_log_off + 32
    xml_log_off = sec_log_off + sec_len

    data_phys = _log_to_phys(data_log_off)
    file_phys_off_of_section = _log_to_phys(sec_log_off)
    section = struct.pack("<B7xQQQ", 1, sec_len, data_phys, 0)

    proto = "".join(
        f'<{f} type="Float" precision="double"/>' for f in fields
    )
    pose_xml = ""
    if pose is not None:
        q, t = pose
        pose_xml = (
            '<pose type="Structure">'
            '<rotation type="Structure">'
            + "".join(f'<{k} type="Float">{v}</{k}>' for k, v in zip("wxyz", q))
            + '</rotation><translation type="Structure">'
            + "".join(f'<{k} type="Float">{v}</{k}>' for k, v in zip("xyz", t))
            + "</translation></pose>"
        )
    xml = (
        f'<?xml version="1.0" encoding="UTF-8"?>'
        f'<e57Root type="Structure" xmlns="{_NS}">'
        f'<formatName type="String"><![CDATA[ASTM E57 3D Imaging Data File]]></formatName>'
        f'<guid type="String"><![CDATA[{{av-tpu-0000}}]]></guid>'
        f'<versionMajor type="Integer">1</versionMajor>'
        f'<versionMinor type="Integer">0</versionMinor>'
        f'<data3D type="Vector" allowHeterogeneousChildren="1">'
        f'<vectorChild type="Structure">'
        f'<guid type="String"><![CDATA[{{av-tpu-scan0}}]]></guid>'
        f"{pose_xml}"
        f'<points type="CompressedVector" fileOffset="{file_phys_off_of_section}" recordCount="{n}">'
        f'<prototype type="Structure">{proto}</prototype>'
        f'<codecs type="Vector" allowHeterogeneousChildren="1"/>'
        f"</points></vectorChild></data3D></e57Root>"
    ).encode("utf-8")

    logical = bytearray(b"\0" * 48) + section + data + xml
    physical = _paginate(bytes(logical))

    header = struct.pack(
        "<8sIIQQQQ",
        _MAGIC,
        1,
        0,
        len(physical),
        _log_to_phys(xml_log_off),
        len(xml),
        PAGE,
    )
    physical = bytearray(physical)
    physical[:48] = header
    # re-checksum page 0 after patching the header
    arr = np.frombuffer(bytes(physical[:PAYLOAD]), np.uint8)
    struct.pack_into("<I", physical, PAYLOAD, crc32c(arr.tobytes()))
    with open(path, "wb") as f:
        f.write(bytes(physical))
