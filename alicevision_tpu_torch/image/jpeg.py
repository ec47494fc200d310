"""The port's JPEG codec: a marker parser, a decoder and a baseline encoder.

The JAX package reads and writes `.jpg` through imageio and PIL, that is
through libjpeg-turbo (`alicevision_tpu/image/io.py:44-46, 61-75`). The
port decodes what libjpeg-turbo decodes at its defaults, to the byte:

- baseline (SOF0), extended-sequential 8-bit (SOF1) and progressive
  (SOF2) Huffman files: DC and AC first and refinement scans, EOB runs,
  restart intervals, byte stuffing and fill bytes, several DHT and DQT
  segments (16-bit DQT too) and non-interleaved scans;
- dequantization and `jpeg_idct_islow`'s integer IDCT;
- fancy upsampling (h2v1, h2v2 and h1v2 triangle filters, box replication
  where libjpeg takes it) and the fixed-point YCbCr -> RGB tables.

`decode` runs the entropy decoder and the pixel stage in C++
(`native/jpeg.cpp`, built with g++ at first use); `decode_plain` is the
plain version (Python Huffman, numpy pixel stage) the tests hold it
against. `encode` writes a baseline file as PIL does at its defaults
(libjpeg's quality scaling of the Annex K tables, the standard Huffman
tables, 4:2:0 with libjpeg's h2v2 downsampling bias, the islow forward
DCT); `encode_plain` is its numpy version. Lossless and hierarchical
frames, arithmetic coding, 12-bit samples, four components and truncated
scans raise ValueError naming what was found.
"""

from __future__ import annotations

import ctypes
import re
import struct

import numpy as np

# zigzag index -> natural index
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_NOT_TAKEN = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical (SOF7)",
    0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)", 0xCB: "arithmetic coding (SOF11)",
    0xCD: "arithmetic coding (SOF13)", 0xCE: "arithmetic coding (SOF14)", 0xCF: "arithmetic coding (SOF15)",
    0xCC: "arithmetic coding (DAC)", 0xDC: "a DNL marker", 0xDE: "hierarchical (DHP)", 0xDF: "hierarchical (EXP)",
}
_ERRORS = {-1: "truncated scan", -2: "a Huffman code no table holds", -3: "a missing or out-of-order RST marker",
           -4: "a run past coefficient 63", -5: "a bad Huffman table", -6: "output buffer full"}

# Annex K: quantizers (natural order) and the standard Huffman tables
# (bits[16], values), the tables libjpeg writes at its defaults
STD_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32,
], np.int64)
_AC_TAIL = [r * 16 + s for r in range(16) for s in range(1, 11)]


def _ac_vals(head: list) -> list:
    """An Annex K AC table's values: its head (the codes up to 8 bits, in
    table order), then the symbols it lacks in increasing order, which is
    how K.5's longer codes are listed."""
    return head + [v for v in _AC_TAIL if v not in head]


STD_HUFF = [  # DC luma, AC luma, DC chroma, AC chroma
    ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_vals([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
        0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
        0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
        0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
        0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
        0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
        0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
        0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2])),
    ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_vals([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
        0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
        0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26])),
]


def _table_row(bits, vals) -> np.ndarray:
    row = np.zeros(272, np.uint8)
    row[:16] = bits
    row[16:16 + len(vals)] = vals
    return row


# ------------------------------------------------------------------ parser


def _segments(data: bytes):
    """Yield (marker, payload start, payload end) of each segment before
    EOI, and for SOS the end of its entropy-coded data (the next marker
    that is not RSTn). Raises ValueError on a file that is not a JPEG or
    ends early."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos, n = 2, len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1  # tolerate garbage between segments, as libjpeg does (with a warning)
        while pos < n and data[pos] == 0xFF:
            pos += 1  # fill bytes
        if pos >= n:
            raise ValueError("truncated JPEG file (no EOI marker)")
        m = data[pos]
        pos += 1
        if m == 0xD9:
            return
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue  # TEM, stray RSTn: no payload
        if pos + 2 > n:
            raise ValueError("truncated JPEG file (a segment header)")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        start, end = pos + 2, pos + length
        if length < 2 or end > n:
            raise ValueError(f"truncated JPEG file (segment 0xFF{m:02X})")
        if m != 0xDA:
            yield m, start, end, None
            pos = end
            continue
        q = end  # entropy-coded data: up to a marker other than RSTn
        while True:
            q = data.find(b"\xff", q)
            if q < 0:
                raise ValueError("truncated scan (no marker after the entropy-coded data)")
            r = q + 1
            while r < n and data[r] == 0xFF:
                r += 1
            if r >= n:
                raise ValueError("truncated scan (no marker after the entropy-coded data)")
            if data[r] == 0 or 0xD0 <= data[r] <= 0xD7:
                q = r + 1
                continue
            break
        yield m, start, end, q
        pos = q


def parse(data: bytes) -> dict:
    """The frame, tables and scans of a JPEG file. Table ids index
    `tables` (272-byte rows: bits[16], values[256]); each scan carries the
    ids in effect at its SOS. Quantization tables are latched per
    component at the first scan that holds it, as libjpeg does."""
    quant: dict = {}
    current = {}  # (class, slot) -> table id
    tables: list = []
    frame = None
    scans: list = []
    restart = 0
    jfif = False
    adobe = None
    latched: dict = {}
    for m, a, b, scan_end in _segments(data):
        seg = data[a:b]
        if m in _NOT_TAKEN:
            raise ValueError(f"JPEG {_NOT_TAKEN[m]} is not taken")
        if m == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDB:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                if pq not in (0, 1) or tq > 3:
                    raise ValueError(f"bad DQT table (precision {pq}, slot {tq})")
                k = 64 * (pq + 1)
                vals = np.frombuffer(seg[p + 1:p + 1 + k], ">u2" if pq else np.uint8).astype(np.int64)
                if len(vals) != 64:
                    raise ValueError("truncated DQT segment")
                tab = np.zeros(64, np.int64)
                tab[NATURAL] = vals
                quant[tq] = tab
                p += 1 + k
        elif m == 0xC4:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                bits = list(seg[p + 1:p + 17])
                nv = sum(bits)
                vals = list(seg[p + 17:p + 17 + nv])
                if tc > 1 or th > 3 or len(bits) != 16 or len(vals) != nv or nv > 256:
                    raise ValueError("bad DHT segment")
                current[(tc, th)] = len(tables)
                tables.append(_table_row(bits, vals))
                p += 17 + nv
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif m in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("JPEG with more than one frame")
            prec, height, width, nf = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"JPEG {prec}-bit samples are not taken (SOF{m - 0xC0}, 8-bit only)")
            if nf == 4:
                raise ValueError("JPEG with 4 components (CMYK/YCCK) is not taken")
            if nf not in (1, 3):
                raise ValueError(f"JPEG with {nf} components is not taken")
            if height == 0:
                raise ValueError("JPEG whose height comes in a DNL marker is not taken")
            comps = []
            for i in range(nf):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4):
                    raise ValueError(f"bad sampling factors {h}x{v}")
                comps.append(dict(id=cid, h=h, v=v, tq=tq))
            frame = dict(width=width, height=height, progressive=m == 0xC2, comps=comps, sof=m)
        elif m == 0xDA:
            if frame is None:
                raise ValueError("SOS before SOF")
            ns = seg[0]
            ids = [c["id"] for c in frame["comps"]]
            sc = dict(comp=[], td=[], ta=[])
            for i in range(ns):
                cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
                if cid not in ids:
                    raise ValueError(f"scan names component {cid}, not in the frame")
                ci = ids.index(cid)
                sc["comp"].append(ci)
                for cls, slot in ((0, t >> 4), (1, t & 15)):
                    if (cls, slot) not in current and slot < 2:
                        # no DHT (Motion JPEG's AVI1 frames): libjpeg-turbo's Annex K defaults
                        current[(cls, slot)] = len(tables)
                        tables.append(_table_row(*STD_HUFF[2 * slot + cls]))
                    sc["ta" if cls else "td"].append(current.get((cls, slot), -1))
                if ci not in latched:
                    tq = frame["comps"][ci]["tq"]
                    if tq not in quant:
                        raise ValueError(f"component {cid} names quantization table {tq}, never defined")
                    latched[ci] = quant[tq].copy()
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            sc.update(ns=ns, ss=ss, se=se, ah=ahal >> 4, al=ahal & 15, ri=restart, off=b, len=scan_end - b)
            _check_scan(frame, sc)
            scans.append(sc)
    if frame is None:
        raise ValueError("JPEG without a frame (no SOF marker)")
    if not scans:
        raise ValueError("truncated JPEG file (no scan)")
    ncomp = len(frame["comps"])
    for ci in range(ncomp):
        latched.setdefault(ci, quant.get(frame["comps"][ci]["tq"], np.ones(64, np.int64)))
    if ncomp == 1:
        color = 0
    elif jfif:
        color = 1
    elif adobe is not None:
        color = 2 if adobe == 0 else 1
    else:
        color = 2 if [c["id"] for c in frame["comps"]] == [82, 71, 66] else 1
    if frame["progressive"]:
        _check_complete(frame, scans)
    return dict(frame=frame, quant=np.stack([latched[ci] for ci in range(ncomp)]), tables=tables,
                scans=scans, color=color)


def _check_scan(frame: dict, sc: dict) -> None:
    if frame["progressive"]:
        ok = sc["se"] <= 63 and sc["ss"] <= sc["se"] and (sc["ss"] > 0 or sc["se"] == 0)
        ok = ok and (sc["ss"] == 0 or sc["ns"] == 1) and sc["al"] <= 13
    else:
        ok = sc["ss"] == 0 and sc["se"] == 63 and sc["ah"] == 0 and sc["al"] == 0
    if not ok or not 1 <= sc["ns"] <= 4:
        raise ValueError(f"bad scan parameters Ss={sc['ss']} Se={sc['se']} Ah={sc['ah']} Al={sc['al']} "
                         f"for {sc['ns']} components")
    needs_dc = not frame["progressive"] or (sc["ss"] == 0 and sc["ah"] == 0)
    needs_ac = not frame["progressive"] or sc["ss"] > 0
    if (needs_dc and min(sc["td"]) < 0) or (needs_ac and min(sc["ta"]) < 0):
        raise ValueError("scan names a Huffman table that was never defined")


def _check_complete(frame: dict, scans: list) -> None:
    """libjpeg smooths the blocks of a progressive file whose scans leave
    one of the coefficients 1-9 incomplete (jdcoefct.c smoothing_ok); this
    decoder does not, so it refuses such a file."""
    bits = np.full((len(frame["comps"]), 64), -1)
    for sc in scans:
        for ci in sc["comp"]:
            bits[ci, sc["ss"]:sc["se"] + 1] = sc["al"]
    if (bits[:, 0] >= 0).all() and (bits[:, 1:10] != 0).any():
        raise ValueError("progressive JPEG whose scans leave coefficients 1-9 incomplete: libjpeg's "
                         "inter-block smoothing is not taken")


def layout(frame: dict) -> dict:
    """Sampling geometry: (h, v, bw, bh, wib, hib, offset) a component (the
    MCU grid's blocks bw x bh, the component's own wib x hib, its first
    block in the coefficient buffer), the MCU grid and the block count."""
    W, H = frame["width"], frame["height"]
    hmax = max(c["h"] for c in frame["comps"])
    vmax = max(c["v"] for c in frame["comps"])
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    rows, off = [], 0
    for c in frame["comps"]:
        bw, bh = mcux * c["h"], mcuy * c["v"]
        wib, hib = -(-W * c["h"] // (8 * hmax)), -(-H * c["v"] // (8 * vmax))
        rows.append([c["h"], c["v"], bw, bh, wib, hib, off])
        off += bw * bh
    return dict(comps=np.array(rows, np.int64), hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy, blocks=off)


def image_size(data: bytes) -> tuple:
    """(width, height) of a JPEG from its first SOF, without decoding."""
    for m, a, b, _ in _segments(data):
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            _, h, w = struct.unpack(">BHH", data[a:a + 5])
            return w, h
        if m == 0xDA:
            break
    raise ValueError("JPEG without a frame (no SOF marker)")


# ------------------------------------------------------------------ decoder


def _scan_rows(info: dict) -> np.ndarray:
    rows = []
    for sc in info["scans"]:
        pad = [-1] * (4 - sc["ns"])
        rows.append([sc["ns"], *(sc["comp"] + pad), *(sc["td"] + pad), *(sc["ta"] + pad), sc["ss"], sc["se"],
                     sc["ah"], sc["al"], sc["ri"], int(info["frame"]["progressive"]), sc["off"], sc["len"], 0])
    return np.array(rows, np.int64)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _shape(frame: dict) -> tuple:
    H, W = frame["height"], frame["width"]
    return (H, W) if len(frame["comps"]) == 1 else (H, W, 3)


def decode(data: bytes) -> np.ndarray:
    """Decode a JPEG in the C++ library -> uint8 (H, W) for one component,
    (H, W, 3) RGB for three, as PIL gives them. Raises ValueError for what
    is not taken and RuntimeError when the library cannot be built."""
    from .. import native

    info = parse(data)
    lib = native.jpeg_library()
    lay = layout(info["frame"])
    buf = np.frombuffer(data, np.uint8)
    coef = np.zeros(lay["blocks"] * 64, np.int16)
    scans = _scan_rows(info)
    tables = np.ascontiguousarray(np.stack(info["tables"])) if info["tables"] else np.zeros((1, 272), np.uint8)
    comps = np.ascontiguousarray(lay["comps"])
    rc = lib.jpeg_decode_coefficients(_ptr(buf), len(buf), len(comps), _ptr(comps), lay["mcux"], lay["mcuy"],
                                      len(scans), _ptr(scans), len(info["tables"]), _ptr(tables), _ptr(coef))
    if rc:
        raise ValueError(f"JPEG: {_ERRORS.get(rc, rc)}")
    return _pixels_native(lib, info, lay, coef)


def _pixels_native(lib, info: dict, lay: dict, coef: np.ndarray) -> np.ndarray:
    frame = info["frame"]
    out = np.empty(_shape(frame), np.uint8)
    quant = np.ascontiguousarray(info["quant"].astype(np.uint16))
    comps = np.ascontiguousarray(lay["comps"])
    rc = lib.jpeg_pixels(len(comps), _ptr(comps), _ptr(coef), _ptr(quant), frame["width"], frame["height"],
                         lay["hmax"], lay["vmax"], info["color"], _ptr(out))
    if rc:
        raise ValueError("JPEG sampling factors that are no integer ratio of the largest are not taken")
    return out


def _huff_lut(row: np.ndarray) -> list:
    """16-bit lookahead table of a Huffman table: (length << 8) | symbol,
    0 where no code starts."""
    lut = np.zeros(1 << 16, np.int64)
    code, p = 0, 0
    for length in range(1, 17):
        for _ in range(int(row[length - 1])):
            if code >= 1 << length or p >= 256:
                raise ValueError("JPEG: a bad Huffman table")
            lut[code << (16 - length):(code + 1) << (16 - length)] = (length << 8) | int(row[16 + p])
            code += 1
            p += 1
        code <<= 1
    return lut.tolist()


_PAD_BITS = 2048


def _windows(seg: bytes) -> tuple:
    """Unstuffed bits of one restart interval as 16-bit windows (the 16
    bits from each position on, zero past the end), and the real bit
    count."""
    seg = re.sub(rb"\xff+\x00", b"\xff", seg.rstrip(b"\xff"))
    bits = np.unpackbits(np.frombuffer(seg, np.uint8)).astype(np.int64)
    n = len(bits)
    padded = np.concatenate([bits, np.zeros(_PAD_BITS + 16, np.int64)])
    w = np.zeros(n + _PAD_BITS, np.int64)
    for j in range(16):
        w = (w << 1) | padded[j:j + n + _PAD_BITS]
    return w.tolist(), n


def _coefficients_plain(data: bytes, info: dict, lay: dict) -> np.ndarray:
    """The entropy decoder in Python: every scan into one flat list of
    coefficients (64 a block, natural order)."""
    coef = [0] * (lay["blocks"] * 64)
    nat = NATURAL.tolist()
    comps = lay["comps"].tolist()
    luts = {}
    progressive = info["frame"]["progressive"]

    def lut(t):
        if t not in luts:
            luts[t] = _huff_lut(info["tables"][t])
        return luts[t]

    for sc in info["scans"]:
        seg = data[sc["off"]:sc["off"] + sc["len"]]
        parts = re.split(rb"\xff+([\xd0-\xd7])", seg)
        intervals, markers = parts[0::2], parts[1::2]
        for i, mk in enumerate(markers):
            if mk[0] != 0xD0 + (i & 7):
                raise ValueError("JPEG: a missing or out-of-order RST marker")
        ns, ss, se, ah, al = sc["ns"], sc["ss"], sc["se"], sc["ah"], sc["al"]
        p1, m1 = 1 << al, -(1 << al)
        dcl = [lut(t) if t >= 0 else None for t in sc["td"]]
        acl = [lut(t) if t >= 0 else None for t in sc["ta"]]
        if ns == 1:
            c = comps[sc["comp"][0]]
            per_row, total = c[4], c[4] * c[5]
        else:
            per_row, total = lay["mcux"], lay["mcux"] * lay["mcuy"]
        ri = sc["ri"] or total
        n_int = -(-total // ri)
        if len(intervals) < n_int:
            raise ValueError("JPEG: a missing or out-of-order RST marker")
        for iv in range(n_int):
            w, nreal = _windows(intervals[iv])
            pos = 0
            pred = [0, 0, 0, 0]
            eobrun = 0

            def get(k):
                nonlocal pos
                if k == 0:
                    return 0
                v = w[pos] >> (16 - k)
                pos += k
                return v

            def sym(table):
                nonlocal pos
                e = table[w[pos]]
                if not e:
                    raise ValueError("JPEG: a Huffman code no table holds")
                pos += e >> 8
                return e & 255

            def dc_sym(table):
                t = sym(table)
                if t > 15:
                    raise ValueError("JPEG: a Huffman code no table holds")
                return t

            def extend(v, s):
                return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

            def block(ci, base):
                nonlocal eobrun
                if not progressive:
                    t = dc_sym(dcl[ci])
                    pred[ci] += extend(get(t), t) if t else 0
                    coef[base] = pred[ci]
                    k = 1
                    table = acl[ci]
                    while k < 64:
                        rs = sym(table)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            if k > 63:
                                raise ValueError("JPEG: a run past coefficient 63")
                            coef[base + nat[k]] = extend(get(s), s)
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
                    return
                if ss == 0:
                    if ah == 0:
                        t = dc_sym(dcl[ci])
                        pred[ci] += extend(get(t), t) if t else 0
                        coef[base] = pred[ci] * p1
                    elif get(1):
                        coef[base] |= p1
                    return
                table = acl[ci]
                if ah == 0:
                    if eobrun > 0:
                        eobrun -= 1
                        return
                    k = ss
                    while k <= se:
                        rs = sym(table)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            if k > 63:
                                raise ValueError("JPEG: a run past coefficient 63")
                            coef[base + nat[k]] = extend(get(s), s) * p1
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = (1 << r) + get(r) - 1
                            break
                        k += 1
                    return
                k = ss
                if eobrun == 0:
                    while k <= se:
                        rs = sym(table)
                        r, s = rs >> 4, rs & 15
                        val = 0
                        if s:
                            val = p1 if get(1) else m1
                        elif r != 15:
                            eobrun = (1 << r) + get(r)
                            break
                        while k <= se:
                            idx = base + nat[k]
                            if coef[idx] != 0:
                                if get(1) and (coef[idx] & p1) == 0:
                                    coef[idx] += p1 if coef[idx] >= 0 else m1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            if k > 63:
                                raise ValueError("JPEG: a run past coefficient 63")
                            coef[base + nat[k]] = val
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        idx = base + nat[k]
                        if coef[idx] != 0 and get(1) and (coef[idx] & p1) == 0:
                            coef[idx] += p1 if coef[idx] >= 0 else m1
                        k += 1
                    eobrun -= 1

            for m in range(iv * ri, min(total, (iv + 1) * ri)):
                my, mx = divmod(m, per_row)
                if ns == 1:
                    c = comps[sc["comp"][0]]
                    block(0, 64 * (c[6] + my * c[2] + mx))
                else:
                    for ci in range(ns):
                        c = comps[sc["comp"][ci]]
                        for yy in range(c[1]):
                            for xx in range(c[0]):
                                block(ci, 64 * (c[6] + (my * c[1] + yy) * c[2] + mx * c[0] + xx))
                if pos > nreal:
                    raise ValueError("JPEG: truncated scan")
    return np.array(coef, np.int64).astype(np.int16)


_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633, f1501=12299, f1847=15137,
          f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _idct_1d(x: list, shift: int) -> list:
    """One pass of jpeg_idct_islow on eight int64 arrays (inputs 0..7),
    descaled by `shift` (11 after the columns, 18 after the rows)."""
    f = _F
    z1 = (x[2] + x[6]) * f["f0541"]
    tmp2, tmp3 = z1 - x[6] * f["f1847"], z1 + x[2] * f["f0765"]
    tmp0, tmp1 = (x[0] + x[4]) << 13, (x[0] - x[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    a1, a2, a3, a4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (a3 + a4) * f["f1175"]
    o0, o1, o2, o3 = o0 * f["f0298"], o1 * f["f2053"], o2 * f["f3072"], o3 * f["f1501"]
    a1, a2 = a1 * -f["f0899"], a2 * -f["f2562"]
    a3, a4 = a3 * -f["f1961"] + z5, a4 * -f["f0390"] + z5
    o0, o1, o2, o3 = o0 + a1 + a3, o1 + a2 + a4, o2 + a2 + a3, o3 + a1 + a4
    rnd = 1 << (shift - 1)
    return [(t10 + o3 + rnd) >> shift, (t11 + o2 + rnd) >> shift, (t12 + o1 + rnd) >> shift,
            (t13 + o0 + rnd) >> shift, (t13 - o0 + rnd) >> shift, (t12 - o1 + rnd) >> shift,
            (t11 - o2 + rnd) >> shift, (t10 - o3 + rnd) >> shift]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) natural-order coefficients, (64,) quantizers -> (N, 8, 8)
    uint8 samples, as jpeg_idct_islow (and its SIMD versions) give them."""
    q = quant.astype(np.int16).astype(np.int64)  # ISLOW_MULT_TYPE is short
    x = (coef.astype(np.int64) * q).reshape(-1, 8, 8)
    ws = np.stack(_idct_1d([x[:, r, :] for r in range(8)], 11), axis=1).astype(np.int32).astype(np.int64)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)], 18), axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _plane(coef: np.ndarray, row: list, quant: np.ndarray) -> np.ndarray:
    h, v, bw, bh, wib, hib, off = row
    blocks = idct_islow(coef[64 * off:64 * (off + bw * bh)].reshape(-1, 64), quant)
    return blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def upsample(plane: np.ndarray, dw: int, dh: int, rh: int, rv: int, W: int, H: int) -> np.ndarray:
    """libjpeg-turbo's jdsample.c at its defaults: a component plane of
    dw x dh real samples -> H x W (edge samples repeat)."""
    P = plane.astype(np.int64)
    ys = np.arange(H)
    if rh == 1 and rv == 1:
        return plane[:H, :W].copy()
    if rv == 2 and (rh == 1 or (rh == 2 and dw > 2)):
        i = ys // 2
        far = np.clip(np.where(ys % 2, i + 1, i - 1), 0, dh - 1)
        if rh == 1:
            bias = np.where(ys % 2, 2, 1)[:, None]
            return ((P[i, :W] * 3 + P[far, :W] + bias) >> 2).astype(np.uint8)
        s = P[i, :dw] * 3 + P[far, :dw]
        even, odd, shift = 8, 7, 4
    elif rh == 2 and rv == 1 and dw > 2:
        s = P[:H, :dw]
        even, odd, shift = 1, 2, 2
    else:  # box replication
        return plane[(ys // rv)[:, None], (np.arange(W) // rh)[None, :]].copy()
    left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
    right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
    out = np.empty((H, 2 * dw), np.int64)
    out[:, 0::2] = (s * 3 + left + even) >> shift
    out[:, 1::2] = (s * 3 + right + odd) >> shift
    return out[:, :W].astype(np.uint8)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's fixed-point YCbCr -> RGB (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r, cb_b = (91881 * x + half) >> 16, (116130 * x + half) >> 16
    cr_g, cb_g = -46802 * x, -22554 * x + half
    Y = y.astype(np.int64)
    rgb = np.stack([Y + cr_r[cr], Y + ((cb_g[cb] + cr_g[cr]) >> 16), Y + cb_b[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def pixels_plain(info: dict, lay: dict, coef: np.ndarray) -> np.ndarray:
    """The numpy pixel stage: dequantize + islow IDCT, upsample, colour."""
    frame = info["frame"]
    W, H = frame["width"], frame["height"]
    rows = lay["comps"].tolist()
    planes = [_plane(coef, r, info["quant"][ci]) for ci, r in enumerate(rows)]
    if len(rows) == 1:
        return planes[0][:H, :W].copy()
    full = []
    for (h, v, *_), P in zip(rows, planes):
        if lay["hmax"] % h or lay["vmax"] % v:
            raise ValueError("JPEG sampling factors that are no integer ratio of the largest are not taken")
        dw, dh = -(-W * h // lay["hmax"]), -(-H * v // lay["vmax"])
        full.append(upsample(P, dw, dh, lay["hmax"] // h, lay["vmax"] // v, W, H))
    if info["color"] == 2:
        return np.stack(full, axis=-1)
    return ycc_to_rgb(*full)


def decode_plain(data: bytes) -> np.ndarray:
    """`decode` in Python and numpy: the plain version of the C++."""
    info = parse(data)
    lay = layout(info["frame"])
    return pixels_plain(info, lay, _coefficients_plain(data, info, lay))


# ------------------------------------------------------------------ encoder

def quant_tables(quality: int) -> np.ndarray:
    """libjpeg's jpeg_set_quality(quality, force_baseline=TRUE): the Annex K
    tables scaled by jpeg_quality_scaling, natural order, (2, 64)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((STD_QUANT * scale + 50) // 100, 1, 255)


def _headers(width: int, height: int, ncomp: int, quant: np.ndarray) -> bytes:
    def seg(m, payload):
        return bytes([0xFF, m]) + struct.pack(">H", len(payload) + 2) + payload

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\0\x01\x01\x00" + struct.pack(">HH", 1, 1) + b"\0\0")
    for t in range(1 if ncomp == 1 else 2):
        out += seg(0xDB, bytes([t]) + bytes(quant[t][NATURAL].astype(np.uint8).tolist()))
    hv = 0x22 if ncomp == 3 else 0x11  # 4:2:0, or one component
    comps = [(1, hv, 0)] + ([(2, 0x11, 1), (3, 0x11, 1)] if ncomp == 3 else [])
    out += seg(0xC0, struct.pack(">BHHB", 8, height, width, ncomp) + b"".join(bytes(c) for c in comps))
    for t, (tc, th) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)][:2 if ncomp == 1 else 4]):
        bits, vals = STD_HUFF[t]
        out += seg(0xC4, bytes([tc << 4 | th] + bits + vals))
    sel = [(1, 0x00)] + ([(2, 0x11), (3, 0x11)] if ncomp == 3 else [])
    return out + seg(0xDA, bytes([ncomp] + [b for c in sel for b in c] + [0, 63, 0]))


def _prepare_encode(img: np.ndarray, quality: int, subsampling: str) -> tuple:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"JPEG takes uint8 pixels, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG takes grey (H, W) or RGB (H, W, 3) pixels, not {img.shape}")
    if subsampling != "4:2:0":
        raise ValueError(f"subsampling {subsampling!r} is not taken (4:2:0)")
    if img.shape[0] < 1 or img.shape[1] < 1 or max(img.shape[:2]) > 65500:
        raise ValueError(f"JPEG takes 1 to 65500 pixels a side, not {img.shape[:2]}")
    ncomp = 1 if img.ndim == 2 else 3
    return img, ncomp, quant_tables(quality)


def encode(img: np.ndarray, quality: int = 75, subsampling: str = "4:2:0") -> bytes:
    """Baseline JPEG of a uint8 grey (H, W) or RGB (H, W, 3, written 4:2:0)
    image, in the C++ library."""
    from .. import native

    img, ncomp, quant = _prepare_encode(img, quality, subsampling)
    lib = native.jpeg_library()
    H, W = img.shape[:2]
    tables = np.ascontiguousarray(np.stack([_table_row(*t) for t in STD_HUFF]))
    q = np.ascontiguousarray(quant.astype(np.uint16))
    cap = img.size // 2 + 65536
    while True:  # a quality-100 noise image can take ~7 bytes a sample with stuffing
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode_scan(_ptr(img), W, H, ncomp, _ptr(q), _ptr(tables), _ptr(out), cap)
        if n != -6:
            break
        cap *= 4
    if n < 0:
        raise ValueError(f"JPEG encoder: {_ERRORS.get(n, n)}")
    return _headers(W, H, ncomp, quant) + out[:n].tobytes() + b"\xff\xd9"


def rgb_to_ycc(img: np.ndarray) -> list:
    """jccolor.c's fixed-point RGB -> YCbCr (SCALEBITS 16)."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    return [((19595 * r + 38470 * g + 7471 * b + half) >> 16).astype(np.uint8),
            ((-11059 * r - 21709 * g + 32768 * b + off + half - 1) >> 16).astype(np.uint8),
            ((32768 * r - 27439 * g - 5329 * b + off + half - 1) >> 16).astype(np.uint8)]


def _fdct_1d(x: list, first: bool) -> list:
    """One pass of jpeg_fdct_islow on eight int64 arrays."""
    f = _F
    t0, t7 = x[0] + x[7], x[0] - x[7]
    t1, t6 = x[1] + x[6], x[1] - x[6]
    t2, t5 = x[2] + x[5], x[2] - x[5]
    t3, t4 = x[3] + x[4], x[3] - x[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    sh = 11 if first else 15
    rnd = 1 << (sh - 1)
    out = [None] * 8
    out[0] = (t10 + t11) * 4 if first else (t10 + t11 + 2) >> 2
    out[4] = (t10 - t11) * 4 if first else (t10 - t11 + 2) >> 2
    z1 = (t12 + t13) * f["f0541"]
    out[2] = (z1 + t13 * f["f0765"] + rnd) >> sh
    out[6] = (z1 - t12 * f["f1847"] + rnd) >> sh
    a1, a2, a3, a4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (a3 + a4) * f["f1175"]
    t4, t5, t6, t7 = t4 * f["f0298"], t5 * f["f2053"], t6 * f["f3072"], t7 * f["f1501"]
    a1, a2 = a1 * -f["f0899"], a2 * -f["f2562"]
    a3, a4 = a3 * -f["f1961"] + z5, a4 * -f["f0390"] + z5
    out[7] = (t4 + a1 + a3 + rnd) >> sh
    out[5] = (t5 + a2 + a4 + rnd) >> sh
    out[3] = (t6 + a2 + a3 + rnd) >> sh
    out[1] = (t7 + a1 + a4 + rnd) >> sh
    return out


def fdct_quantize(blocks: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples -> (N, 64) quantized coefficients, natural
    order (jpeg_fdct_islow, then libjpeg's rounded division by q * 8)."""
    x = blocks.astype(np.int64) - 128
    rows = np.stack(_fdct_1d([x[:, :, k] for k in range(8)], True), axis=2)
    d = np.stack(_fdct_1d([rows[:, r, :] for r in range(8)], False), axis=1).reshape(-1, 64)
    qv = quant.astype(np.int64) * 8
    t = (np.abs(d) + (qv >> 1)) // qv
    return np.where(d < 0, -t, t)


def _component_planes(img: np.ndarray, ncomp: int) -> list:
    """Each component padded to its blocks as libjpeg pads it: columns
    repeated at full resolution before downsampling, rows repeated after."""
    H, W = img.shape[:2]
    full = [img] if ncomp == 1 else rgb_to_ycc(img)
    hmax = 2 if ncomp == 3 else 1
    out = []
    for c, P in enumerate(full):
        h = hmax if c == 0 else 1
        rh = hmax // h
        wib, hib = -(-W * h // (8 * hmax)), -(-H * h // (8 * hmax))
        dh = -(-H // rh)
        ys = np.minimum(np.arange(hib * 8), dh - 1)
        xs = np.arange(wib * 8)
        if rh == 1:
            plane = P[np.minimum(ys, H - 1)[:, None], np.minimum(xs, W - 1)[None, :]]
        else:
            Q = P.astype(np.int64)
            r0, r1 = np.minimum(2 * ys, H - 1)[:, None], np.minimum(2 * ys + 1, H - 1)[:, None]
            x0, x1 = np.minimum(2 * xs, W - 1)[None, :], np.minimum(2 * xs + 1, W - 1)[None, :]
            plane = ((Q[r0, x0] + Q[r0, x1] + Q[r1, x0] + Q[r1, x1] + 1 + (xs & 1)[None, :]) >> 2).astype(np.uint8)
        out.append((h, wib, hib, plane))
    return out


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, bits: int, length: int):
        self.acc = (self.acc << length) | (bits & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put(0x7F, 7)
        return bytes(self.out)


def _code_tables() -> list:
    tabs = []
    for bits, vals in STD_HUFF:
        code, p, tab = 0, 0, {}
        for length in range(1, 17):
            for _ in range(bits[length - 1]):
                tab[vals[p]] = (code, length)
                code += 1
                p += 1
            code <<= 1
        tabs.append(tab)
    return tabs


def encode_plain(img: np.ndarray, quality: int = 75, subsampling: str = "4:2:0") -> bytes:
    """`encode` in numpy (the transform) and Python (the Huffman coder):
    the plain version of the C++."""
    img, ncomp, quant = _prepare_encode(img, quality, subsampling)
    H, W = img.shape[:2]
    comps = []
    for c, (h, wib, hib, plane) in enumerate(_component_planes(img, ncomp)):
        blocks = plane.reshape(hib, 8, wib, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        comps.append((h, wib, hib, fdct_quantize(blocks, quant[min(c, 1)]).reshape(hib, wib, 64)))
    codes = _code_tables()
    bw = _BitWriter()
    pred = [0, 0, 0]
    nat = NATURAL.tolist()

    def emit(c, blk):
        dc, ac = codes[0 if c == 0 else 2], codes[1 if c == 0 else 3]
        diff = int(blk[0]) - pred[c]
        pred[c] = int(blk[0])
        s = abs(diff).bit_length()
        bw.put(*dc[s])
        if s:
            bw.put(diff - 1 if diff < 0 else diff, s)
        run = 0
        vals = blk.tolist()
        for k in range(1, 64):
            v = vals[nat[k]]
            if v == 0:
                run += 1
                continue
            while run > 15:
                bw.put(*ac[0xF0])
                run -= 16
            sz = abs(v).bit_length()
            bw.put(*ac[(run << 4) | sz])
            bw.put(v - 1 if v < 0 else v, sz)
            run = 0
        if run:
            bw.put(*ac[0])

    if ncomp == 1:
        _, wib, hib, q = comps[0]
        for blk in q.reshape(-1, 64):
            emit(0, blk)
    else:
        hmax = comps[0][0]
        mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * hmax))
        for my in range(mcuy):
            for mx in range(mcux):
                for c, (h, wib, hib, q) in enumerate(comps):
                    last_dc = 0
                    for yy in range(h):
                        by, row_dc = my * h + yy, last_dc
                        for xx in range(h):
                            bx = mx * h + xx
                            if by < hib and bx < wib:
                                blk = q[by, bx]
                            else:
                                blk = np.zeros(64, np.int64)
                                blk[0] = last_dc if by < hib else row_dc
                            last_dc = int(blk[0])
                            emit(c, blk)
    return _headers(W, H, ncomp, quant) + bw.flush() + b"\xff\xd9"


def write_jpeg(path: str, img: np.ndarray, quality: int = 75, subsampling: str = "4:2:0") -> None:
    """Write a uint8 grey or RGB image as a baseline JPEG (no EXIF), at
    PIL's defaults unless told otherwise."""
    data = encode(img, quality, subsampling)
    with open(path, "wb") as f:
        f.write(data)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())
