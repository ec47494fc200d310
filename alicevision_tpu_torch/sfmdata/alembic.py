"""Native Alembic (.abc) scene IO — no Alembic library required.

A host copy of `alicevision_tpu/sfmdata/alembic.py` (numpy and struct
only); it writes the same bytes.

The reference's default SfM interchange format is Alembic via the official
C++ library (ref: src/aliceVision/sfmDataIO/AlembicExporter.cpp,
AlembicImporter.cpp, dispatched from sfmDataIO.cpp:114-170). This module
implements the two layers natively:

1. **Ogawa container** (Alembic's binary archive format): a tree of groups
   (uint64 child-reference lists; high bit marks a data leaf) and data
   blobs (uint64 size + payload), with the root group offset in the
   16-byte header.
2. **AbcCoreOgawa object/property encoding**: the archive root's six
   children (archive version, file version, object tree, archive metadata,
   time samplings, indexed metadata); object groups = [top compound,
   child objects..., child-header blob]; compound-property groups =
   [per-property storage..., property-header blob]. Property headers pack
   type/POD/extent/metadata-index into a uint32
   (ptype@0, sizeHint@2, pod@4, flags@8, extent@12, metaIndex@20); samples
   are 16-byte key + payload blobs, array samples carry a dims blob.

The AliceVision schema mapped on top mirrors the reference exporter
exactly: mvgRoot/mvgCameras/mvgCamerasUndefined/mvgCloud/mvgPointCloud
xforms, per-view camxform + camera objects with `mvg_*` user properties,
point cloud with P / color / visibility arrays. Pose and point coordinates
use the computer-graphics flip M = diag(1,-1,-1): stored xform matrix is
((M·T·M)^-1)^T for world->camera T, points are stored (x,-y,-z)
(ref: AlembicExporter.cpp:115-137, AlembicImporter.cpp:760-790,198-205).

The layout was validated byte-for-byte against the reference's
compatibilityData archives (scene_v1.2.*.abc), whose .json twins provide
ground truth for the round-trip tests.
"""

from __future__ import annotations

import struct

import numpy as np

from .scene import SfMData, INVALID

_UNDEF = 4294967295  # UndefinedIndexT (ref: src/aliceVision/types.hpp)
_EMPTY_DATA = 0x8000000000000000

# Alembic PlainOldDataType -> numpy dtype (kStringPOD = 12 handled apart)
_POD_NP = {
    0: np.uint8,  # bool
    1: np.uint8,
    2: np.int8,
    3: np.uint16,
    4: np.int16,
    5: np.uint32,
    6: np.int32,
    7: np.uint64,
    8: np.int64,
    9: np.float16,
    10: np.float32,
    11: np.float64,
}
_POD_STR = 12

# Indexed-metadata table replicated from reference-written archives; the
# writer refers to these by index so our files carry the same schema tags.
_METAS = [
    b"",
    b"arrayExtent=1;geoScope=vtx;interpretation=rgb;isGeomParam=true;podExtent=3;podName=float32_t",
    b"interpretation=box",
    b"geoScope=var;interpretation=point",
    b"geoScope=var",
    b"schema=AbcGeom_Points_v1;schemaBaseType=AbcGeom_GeomBase_v1",
    b"schema=AbcGeom_Camera_v1",
    b"schema=AbcGeom_Camera_v1;schemaObjTitle=AbcGeom_Camera_v1:.geom",
    b"schema=AbcGeom_Xform_v3",
    b"schema=AbcGeom_Points_v1;schemaBaseType=AbcGeom_GeomBase_v1;schemaObjTitle=AbcGeom_Points_v1:.geom",
    b"schema=AbcGeom_Xform_v3;schemaObjTitle=AbcGeom_Xform_v3:.xform",
]
_META_IDX = {m: i for i, m in enumerate(_METAS)}

_DESC_CODE_TO_NAME = {
    0: "unknown", 1: "uninitialized", 10: "sift", 11: "sift_float",
    12: "sift_upright", 13: "dspsift", 20: "akaze", 21: "akaze_liop",
    22: "akaze_mldb", 30: "cctag3", 31: "cctag4", 40: "sift_ocv",
    41: "akaze_ocv", 50: "tag16h5",
}
_DESC_NAME_TO_CODE = {v: k for k, v in _DESC_CODE_TO_NAME.items()}


def _murmur3_x64_128(data: bytes, seed: int = 0) -> bytes:
    """MurmurHash3 x64 128 — Alembic's sample-key digest. Pure python over
    16-byte blocks; sample counts are small and payloads modest."""
    m = (1 << 64) - 1
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F
    h1 = h2 = seed & m
    n = len(data)
    nblocks = n // 16

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    if nblocks:
        ks = np.frombuffer(data[: nblocks * 16], dtype="<u8")
        for i in range(nblocks):
            k1, k2 = int(ks[2 * i]), int(ks[2 * i + 1])
            k1 = (rotl((k1 * c1) & m, 31) * c2) & m
            h1 = ((rotl(h1 ^ k1, 27) + h2) * 5 + 0x52DCE729) & m
            k2 = (rotl((k2 * c2) & m, 33) * c1) & m
            h2 = ((rotl(h2 ^ k2, 31) + h1) * 5 + 0x38495AB5) & m
    tail = data[nblocks * 16 :]
    k1 = k2 = 0
    for i in range(len(tail) - 1, 7, -1):
        k2 = (k2 << 8) | tail[i]
    for i in range(min(len(tail), 8) - 1, -1, -1):
        k1 = (k1 << 8) | tail[i]
    if len(tail) > 8:
        k2 = (rotl((k2 * c2) & m, 33) * c1) & m
        h2 ^= k2
    if len(tail) > 0:
        k1 = (rotl((k1 * c1) & m, 31) * c2) & m
        h1 ^= k1
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & m
    h2 = (h2 + h1) & m

    def fmix(k):
        k ^= k >> 33
        k = (k * 0xFF51AFD7ED558CCD) & m
        k ^= k >> 33
        k = (k * 0xC4CEB9FE1A85EC53) & m
        return k ^ (k >> 33)

    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = (h1 + h2) & m
    h2 = (h2 + h1) & m
    return struct.pack("<QQ", h1, h2)


# ===========================================================================
# Ogawa container — reader
# ===========================================================================


class _Ogawa:
    def __init__(self, buf: bytes):
        if buf[:5] != b"Ogawa":
            raise ValueError("not an Ogawa archive")
        if buf[5] != 0xFF:
            raise ValueError("Ogawa archive not frozen (incomplete write)")
        self.buf = buf
        self.root = struct.unpack("<Q", buf[8:16])[0]

    def group(self, ref: int) -> list[int]:
        if ref == 0:
            return []
        n = struct.unpack("<Q", self.buf[ref : ref + 8])[0]
        return list(
            struct.unpack(f"<{n}Q", self.buf[ref + 8 : ref + 8 + 8 * n])
        )

    def data(self, ref: int) -> bytes:
        off = ref & ~_EMPTY_DATA
        if off == 0:
            return b""
        n = struct.unpack("<Q", self.buf[off : off + 8])[0]
        return self.buf[off + 8 : off + 8 + n]

    @staticmethod
    def is_data(ref: int) -> bool:
        return bool(ref & _EMPTY_DATA)


# ===========================================================================
# Alembic layer — reader
# ===========================================================================


class AbcProperty:
    """Scalar or array property: lazily-decoded samples."""

    def __init__(self, og, name, ptype, pod, extent, meta, sample_refs):
        self._og = og
        self.name = name
        self.ptype = ptype  # 1 scalar, 2 array
        self.pod = pod
        self.extent = extent
        self.meta = meta
        self._refs = sample_refs  # scalar: [data]; array: [(data, dims), ...]

    @property
    def n_samples(self):
        return len(self._refs)

    def scalar(self, i: int = 0):
        d = self._og.data(self._refs[i])
        payload = d[16:] if len(d) >= 16 else b""
        if self.pod == _POD_STR:
            return payload.rstrip(b"\x00").decode("utf-8", "replace")
        a = np.frombuffer(payload, dtype=_POD_NP[self.pod])
        if self.pod == 0:
            a = a.astype(bool)
        return a[0] if self.extent == 1 and a.size == 1 else a

    def array(self, i: int = 0):
        dref, dimsref = self._refs[i]
        d = self._og.data(dref)
        payload = d[16:] if len(d) >= 16 else b""
        dims = self._og.data(dimsref)
        if self.pod == _POD_STR:
            cnt = struct.unpack("<Q", dims[:8])[0] if len(dims) >= 8 else 0
            if cnt == 0:
                return []
            parts = payload.split(b"\x00")
            return [p.decode("utf-8", "replace") for p in parts[:cnt]]
        a = np.frombuffer(payload, dtype=_POD_NP[self.pod])
        if self.pod == 0:
            a = a.astype(bool)
        if self.extent > 1:
            a = a.reshape(-1, self.extent)
        return a


class AbcCompound(dict):
    """name -> AbcProperty | AbcCompound."""


class AbcObject:
    def __init__(self, name, meta, props, children):
        self.name = name
        self.meta = meta
        self.props: AbcCompound = props
        self.children: dict[str, AbcObject] = children


def _parse_indexed_meta(og) -> list[bytes]:
    root = og.group(og.root)
    data = og.data(root[5]) if len(root) > 5 else b""
    metas = [b""]
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        metas.append(data[i : i + n])
        i += n
    return metas


def _parse_compound(og, ref, metas) -> AbcCompound:
    out = AbcCompound()
    g = og.group(ref)
    if not g:
        return out
    hdr = og.data(g[-1]) if og.is_data(g[-1]) else b""
    i = 0
    ci = 0
    while i < len(hdr):
        info = struct.unpack("<I", hdr[i : i + 4])[0]
        i += 4
        ptype = info & 3
        sizehint = (info >> 2) & 3
        pod = (info >> 4) & 0xF
        extent = (info >> 12) & 0xFF
        mi = (info >> 20) & 0xFF
        w, f = {0: (1, "B"), 1: (2, "H"), 2: (4, "I")}[sizehint]
        ns = 0
        if ptype != 0:
            ns = struct.unpack("<" + f, hdr[i : i + w])[0]
            i += w
            if ns > 1 and not (info & 0x200):
                i += 2 * w  # first/last changed sample indices
            if info & 0x100:
                i += w  # time sampling index
        nl = hdr[i]
        i += 1
        name = hdr[i : i + nl].decode("utf-8", "replace")
        i += nl
        if mi == 0xFF:
            ml = struct.unpack("<I", hdr[i : i + 4])[0]
            i += 4
            meta = hdr[i : i + ml].decode("utf-8", "replace")
            i += ml
        else:
            meta = metas[mi].decode() if mi < len(metas) else ""
        child = g[ci]
        ci += 1
        if ptype == 0:
            out[name] = _parse_compound(og, child, metas)
        else:
            sg = og.group(child) if child else []
            if ptype == 1:
                refs = sg[:ns] if ns else sg
            else:
                pairs = list(zip(sg[0::2], sg[1::2]))
                refs = pairs[:ns] if ns else pairs
            out[name] = AbcProperty(og, name, ptype, pod, extent, meta, refs)
    return out


def _parse_object(og, ref, name, meta, metas) -> AbcObject:
    g = og.group(ref)
    props = _parse_compound(og, g[0], metas) if g else AbcCompound()
    children = {}
    if g and og.is_data(g[-1]):
        hdr = og.data(g[-1])
        i = 0
        ci = 1
        while i < len(hdr) - 32:
            n = struct.unpack("<I", hdr[i : i + 4])[0]
            i += 4
            cname = hdr[i : i + n].decode("utf-8", "replace")
            i += n
            mi = hdr[i]
            i += 1
            if mi == 0xFF:
                ml = struct.unpack("<I", hdr[i : i + 4])[0]
                i += 4
                cmeta = hdr[i : i + ml].decode("utf-8", "replace")
                i += ml
            else:
                cmeta = metas[mi].decode() if mi < len(metas) else ""
            children[cname] = _parse_object(og, g[ci], cname, cmeta, metas)
            ci += 1
    return AbcObject(name, meta, props, children)


def read_archive(path: str) -> AbcObject:
    """Parse an Alembic archive into the object/property tree (top object)."""
    with open(path, "rb") as f:
        og = _Ogawa(f.read())
    metas = _parse_indexed_meta(og)
    root = og.group(og.root)
    return _parse_object(og, root[2], "ABC", "", metas)


# ===========================================================================
# Ogawa container — writer
# ===========================================================================


class _OgawaWriter:
    def __init__(self):
        self.parts = [b"Ogawa\xff\x00\x01" + b"\x00" * 8]
        self.pos = 16

    def _append(self, b: bytes) -> int:
        off = self.pos
        self.parts.append(b)
        self.pos += len(b)
        return off

    def data(self, payload: bytes) -> int:
        if len(payload) == 0:
            return _EMPTY_DATA
        off = self._append(struct.pack("<Q", len(payload)) + payload)
        return off | _EMPTY_DATA

    def group(self, children: list[int]) -> int:
        if not children:
            return 0
        return self._append(
            struct.pack("<Q", len(children))
            + struct.pack(f"<{len(children)}Q", *children)
        )

    def finalize(self, root_ref: int) -> bytes:
        head = bytearray(self.parts[0])
        head[8:16] = struct.pack("<Q", root_ref)
        self.parts[0] = bytes(head)
        return b"".join(self.parts)


# ===========================================================================
# Alembic layer — writer
# ===========================================================================


class WProp:
    """ptype 1 (scalar) / 2 (array). value: np array | str | list[str]."""

    def __init__(self, name, ptype, pod, extent, value, meta=b""):
        self.name, self.ptype, self.pod = name, ptype, pod
        self.extent, self.value, self.meta = extent, value, meta


class WCompound:
    def __init__(self, name, children=None, meta=b""):
        self.name = name
        self.children = children if children is not None else []
        self.meta = meta


class WObject:
    def __init__(self, name, meta=b"", props=None, children=None):
        self.name = name
        self.meta = meta
        self.props = props if props is not None else []
        self.children = children if children is not None else []


def _pod_bytes(pod, value, extent):
    if pod == _POD_STR:
        if isinstance(value, str):
            return value.encode() + b"\x00", 1
        payload = b"".join(s.encode() + b"\x00" for s in value)
        return payload, len(value)
    a = np.ascontiguousarray(value, dtype=_POD_NP[pod])
    n = a.size // max(extent, 1)
    return a.tobytes(), n


def _emit_prop(w: _OgawaWriter, p) -> tuple[int, bytes]:
    """-> (group ref, header bytes)."""
    if isinstance(p, WCompound):
        refs, hdr = [], b""
        for c in p.children:
            r, h = _emit_prop(w, c)
            refs.append(r)
            hdr += h
        g = w.group(refs + [w.data(hdr)]) if p.children else 0
        info = _META_IDX.get(p.meta, 0) << 20
        myhdr = struct.pack("<I", info) + bytes([len(p.name)]) + p.name.encode()
        if p.meta and p.meta not in _META_IDX:
            info = 0xFF << 20
            myhdr = (
                struct.pack("<I", info)
                + bytes([len(p.name)])
                + p.name.encode()
                + struct.pack("<I", len(p.meta))
                + p.meta
            )
        return g, myhdr

    payload, n = _pod_bytes(p.pod, p.value, p.extent)
    key = _murmur3_x64_128(payload) if payload else b""
    sample = w.data(key + payload) if payload else w.data(b"")
    if p.ptype == 1:
        g = w.group([sample])
    else:
        if p.pod == _POD_STR:
            dims = w.data(struct.pack("<Q", n))
        else:
            dims = w.data(b"")
        g = w.group([sample, dims])
    # flags 0xC00 mirror the reference's static single-sample properties
    info = (
        p.ptype
        | (p.pod << 4)
        | 0xC00
        | (p.extent << 12)
        | (_META_IDX.get(p.meta, 0) << 20)
    )
    hdr = struct.pack("<I", info) + b"\x01" + bytes([len(p.name)]) + p.name.encode()
    if p.meta and p.meta not in _META_IDX:
        info = (info & ~(0xFF << 20)) | (0xFF << 20)
        hdr = (
            struct.pack("<I", info)
            + b"\x01"
            + bytes([len(p.name)])
            + p.name.encode()
            + struct.pack("<I", len(p.meta))
            + p.meta
        )
    return g, hdr


def _emit_object(w: _OgawaWriter, o: WObject) -> int:
    prefs, phdr = [], b""
    for p in o.props:
        r, h = _emit_prop(w, p)
        prefs.append(r)
        phdr += h
    props_ref = w.group(prefs + [w.data(phdr)]) if o.props else 0

    crefs, chdr = [], b""
    for c in o.children:
        crefs.append(_emit_object(w, c))
        mi = _META_IDX.get(c.meta, None)
        chdr += struct.pack("<I", len(c.name)) + c.name.encode()
        if mi is None:
            chdr += b"\xff" + struct.pack("<I", len(c.meta)) + c.meta
        else:
            chdr += bytes([mi])
    # 32 trailing bytes: properties/children hash (informational only —
    # Alembic readers expose but never verify them)
    hdr_ref = w.data(chdr + b"\x00" * 32)
    return w.group([props_ref] + crefs + [hdr_ref])


def write_archive(top: WObject, path: str, app: str = "alicevision_tpu") -> None:
    w = _OgawaWriter()
    top_ref = _emit_object(w, top)
    meta_blob = b"".join(bytes([len(m)]) + m for m in _METAS[1:])
    # default uniform time sampling (1 sample at t=0, 1 tick/cycle)
    ts = struct.pack("<I", 1) + struct.pack("<d", 1.0) + struct.pack("<I", 1) + struct.pack("<d", 0.0)
    root = w.group(
        [
            w.data(struct.pack("<I", 0)),
            w.data(struct.pack("<I", 10804)),  # file version (Alembic 1.8.4)
            top_ref,
            w.data(f"_ai_AlembicVersion=Alembic 1.8.4;_ai_Application={app}".encode()),
            w.data(ts),
            w.data(meta_blob),
        ]
    )
    with open(path, "wb") as f:
        f.write(w.finalize(root))


# ===========================================================================
# AliceVision schema — import
# ===========================================================================

_M_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def _xform_matrix(obj: AbcObject) -> np.ndarray | None:
    x = obj.props.get(".xform")
    if not isinstance(x, AbcCompound):
        return None
    vals = x.get(".vals")
    if vals is None or vals.n_samples == 0:
        return None
    v = np.asarray(vals.scalar(0), np.float64)
    if v.size != 16:
        return None
    return v.reshape(4, 4).T  # M44d row-major storage, importer transposes


def _pose_from_mat(mat: np.ndarray, old_version: bool):
    """-> (R world->cam, center)."""
    if old_version:
        T2 = np.linalg.inv(mat @ _M_FLIP)
    else:
        T2 = np.linalg.inv(_M_FLIP @ mat @ _M_FLIP)
    R = T2[:3, :3]
    t = T2[:3, 3]
    c = -R.T @ t
    return R, c


def _u(prop, default=None):
    if prop is None or prop.n_samples == 0:
        return default
    return prop.scalar(0)


def load_abc(path: str) -> SfMData:
    """Load an AliceVision Alembic scene into SfMData
    (ref: sfmDataIO/AlembicImporter.cpp)."""
    from . import io as sfmio

    top = read_archive(path)
    mvg_root = top.children.get("mvgRoot")
    if mvg_root is None:
        raise ValueError(f"{path}: no mvgRoot object — not an AliceVision archive")
    ver = (1, 0, 0)
    vp = mvg_root.props.get("mvg_ABC_version")
    if vp is not None and vp.n_samples:
        va = np.atleast_1d(np.asarray(vp.array(0)))
        ver = tuple(int(x) for x in va[:3]) + (0,) * max(0, 3 - va.size)
    old_version = ver < (1, 2, 3)

    scene = SfMData.empty()
    views = []  # dicts
    poses = {}  # poseId -> (R, c, locked)
    intr = {}  # intrinsicId -> dict

    def visit_cam_container(container: AbcObject, reconstructed: bool, chain=()):
        for name, obj in container.children.items():
            cams = [c for c in obj.children.values() if ".geom" in c.props
                    and "schema=AbcGeom_Camera" in c.meta]
            mat = _xform_matrix(obj)
            chain2 = chain + ((mat,) if mat is not None else ())
            if not cams:
                visit_cam_container(obj, reconstructed, chain2)
                continue
            cam = cams[0]
            geom = cam.props.get(".geom", AbcCompound())
            up = geom.get(".userProperties", AbcCompound())
            view_id = int(_u(up.get("mvg_viewId"), len(views)))
            pose_id = int(_u(up.get("mvg_poseId"), view_id))
            intr_id = int(_u(up.get("mvg_intrinsicId"), 0))
            ssp = np.atleast_1d(up["mvg_sensorSizePix"].array(0)) if "mvg_sensorSizePix" in up else np.array([0, 0])
            v = {
                "viewId": view_id,
                "poseId": pose_id,
                "intrinsicId": intr_id,
                "path": _u(up.get("mvg_imagePath"), ""),
                "frameId": int(_u(up.get("mvg_frameId"), _UNDEF)),
                "width": int(ssp[0]),
                "height": int(ssp[1]) if ssp.size > 1 else 0,
                "resectionId": int(_u(up.get("mvg_resectionId"), _UNDEF)),
                "metadata": list(up["mvg_metadata"].array(0)) if "mvg_metadata" in up else [],
                "posed": reconstructed,
            }
            views.append(v)
            if reconstructed and chain2:
                m = chain2[0]
                for extra in chain2[1:]:
                    m = m @ extra  # compose nested (rig) transforms
                R, c = _pose_from_mat(m, old_version)
                locked = bool(_u(up.get("mvg_poseLocked"), False))
                poses.setdefault(pose_id, (R, c, locked))
            if intr_id not in intr and "mvg_intrinsicType" in up:
                params = np.atleast_1d(up["mvg_intrinsicParams"].array(0)) if "mvg_intrinsicParams" in up else np.zeros(4)
                ssmm = np.atleast_1d(up["mvg_sensorSizeMm"].array(0)) if "mvg_sensorSizeMm" in up else np.array([36.0, 24.0])
                intr[intr_id] = {
                    "type": str(_u(up.get("mvg_intrinsicType"), "pinhole")),
                    "distortionType": str(_u(up.get("mvg_distortionType"), "none")),
                    "params": np.asarray(params, np.float64),
                    "width": v["width"],
                    "height": v["height"],
                    "sensorMm": np.asarray(ssmm, np.float64)[:2],
                    "serial": str(_u(up.get("mvg_intrinsicSerialNumber"), "")),
                    "initialFocalLength": float(_u(up.get("mvg_initialFocalLength"), -1.0)),
                    "initializationMode": str(_u(up.get("mvg_intrinsicInitializationMode"), "none")),
                }

    cams_grp = mvg_root.children.get("mvgCameras")
    if cams_grp is not None:
        visit_cam_container(cams_grp, True)
    und_grp = mvg_root.children.get("mvgCamerasUndefined")
    if und_grp is not None:
        visit_cam_container(und_grp, False)

    # ----- point cloud -----
    pts = np.zeros((0, 3))
    colors = np.zeros((0, 3), np.uint8)
    desc_codes = np.zeros(0, np.uint32)
    vis_size = vis_view = vis_feat = None
    feat_pos = feat_scale = None
    cloud = mvg_root.children.get("mvgCloud")
    pc = cloud.children.get("mvgPointCloud") if cloud else None
    if pc is not None:
        for shp in pc.children.values():
            geom = shp.props.get(".geom")
            if not isinstance(geom, AbcCompound) or "P" not in geom:
                continue
            P = np.asarray(geom["P"].array(0), np.float64).reshape(-1, 3)
            pts = P if old_version else P * np.array([1.0, -1.0, -1.0])
            arb = geom.get(".arbGeomParams", AbcCompound())
            if "color" in arb:
                c = np.asarray(arb["color"].array(0), np.float64).reshape(-1, 3)
                if len(c) == len(pts):
                    colors = np.clip(c * 255.0, 0, 255).astype(np.uint8)
            up = geom.get(".userProperties", AbcCompound())
            if "mvg_describerType" in up:
                desc_codes = np.atleast_1d(up["mvg_describerType"].array(0))
            if "mvg_visibilitySize" in up:
                vis_size = np.atleast_1d(up["mvg_visibilitySize"].array(0)).astype(np.int64)
                if "mvg_visibilityViewId" in up:
                    vis_view = np.atleast_1d(up["mvg_visibilityViewId"].array(0)).astype(np.int64)
                    if "mvg_visibilityFeatId" in up:
                        vis_feat = np.atleast_1d(up["mvg_visibilityFeatId"].array(0)).astype(np.int64)
                elif "mvg_visibilityIds" in up:  # legacy (viewId, featId) pairs
                    ids = np.atleast_1d(up["mvg_visibilityIds"].array(0)).astype(np.int64)
                    vis_view = ids[0::2]
                    vis_feat = ids[1::2]
                if "mvg_visibilityFeatPos" in up:
                    feat_pos = np.atleast_1d(up["mvg_visibilityFeatPos"].array(0)).astype(np.float64).reshape(-1, 2)
                if "mvg_visibilityFeatScale" in up:
                    feat_scale = np.atleast_1d(up["mvg_visibilityFeatScale"].array(0)).astype(np.float64)
            break

    # ----- assemble SfMData -----
    V = len(views)
    pose_ids = sorted(poses.keys())
    pose_index = {p: i for i, p in enumerate(pose_ids)}
    intr_ids = sorted(intr.keys())
    intr_index = {p: i for i, p in enumerate(intr_ids)}

    scene.view_ids = np.array([v["viewId"] for v in views], np.int64)
    scene.view_intrinsic = np.array(
        [intr_index.get(v["intrinsicId"], INVALID) for v in views], np.int32
    )
    scene.view_pose = np.array(
        [pose_index.get(v["poseId"], INVALID) if v["posed"] else INVALID for v in views],
        np.int32,
    )
    scene.view_sizes = np.array([[v["width"], v["height"]] for v in views], np.int32).reshape(V, 2)
    scene.view_paths = [v["path"] for v in views]
    scene.view_frames = np.array([v["frameId"] for v in views], np.int64)
    scene.view_metadata = [
        {"resectionId": v["resectionId"],
         **dict(zip(v["metadata"][0::2], v["metadata"][1::2]))}
        for v in views
    ]

    scene.pose_ids = np.array(pose_ids, np.int64)
    scene.pose_R = np.stack([poses[p][0] for p in pose_ids]) if pose_ids else np.zeros((0, 3, 3))
    scene.pose_c = np.stack([poses[p][1] for p in pose_ids]) if pose_ids else np.zeros((0, 3))
    scene.pose_locked = np.array([poses[p][2] for p in pose_ids], bool)

    from ..camera import models as cammod

    I = len(intr_ids)
    scene.intrinsic_ids = np.array(intr_ids, np.int64)
    scene.cam_kind = np.zeros(I, np.int32)
    scene.disto_kind = np.zeros(I, np.int32)
    scene.scale = np.zeros((I, 2))
    scene.offset = np.zeros((I, 2))
    scene.sizes = np.zeros((I, 2), np.int32)
    scene.disto = np.zeros((I, scene.disto.shape[1] if scene.disto.ndim == 2 and scene.disto.shape[1] else 8))
    scene.sensor_size = np.zeros((I, 2))
    scene.intrinsic_extra = []
    for i, iid in enumerate(intr_ids):
        d = intr[iid]
        ck, dk = sfmio._LEGACY.get(d["type"], (cammod.CAM_PINHOLE, cammod.DISTO_NONE))
        if d["distortionType"] != "none" and d["distortionType"] in sfmio._NAME_TO_DISTO:
            dk = sfmio._NAME_TO_DISTO[d["distortionType"]]
        scene.cam_kind[i] = ck
        scene.disto_kind[i] = dk
        p = d["params"]
        if ver < (1, 2, 0) and p.size >= 3:
            # single focal for X and Y before 1.2.0
            # (ref: camera/IntrinsicScaleOffset.cpp importFromParams)
            p = np.concatenate([[p[0]], p])
        if p.size >= 4:
            scene.scale[i] = p[:2]
            scene.offset[i] = p[2:4]
            if ver < (1, 2, 1):
                # offset was stored as absolute principal point
                scene.offset[i] -= (d["width"] / 2.0, d["height"] / 2.0)
            nd = min(p.size - 4, scene.disto.shape[1])
            scene.disto[i, :nd] = p[4 : 4 + nd]
        scene.sizes[i] = (d["width"], d["height"])
        scene.sensor_size[i] = d["sensorMm"]
        scene.intrinsic_extra.append(
            {"serialNumber": d["serial"],
             "initialFocalLength": d["initialFocalLength"],
             "initializationMode": d["initializationMode"]}
        )

    L = len(pts)
    scene.landmark_ids = np.arange(L, dtype=np.int64)
    scene.points = np.asarray(pts, np.float64)
    scene.colors = colors if len(colors) == L else np.zeros((L, 3), np.uint8)
    scene.desc_types = [
        _DESC_CODE_TO_NAME.get(int(c), "unknown") for c in desc_codes
    ] if desc_codes.size == L else ["sift"] * L

    if vis_size is not None and vis_view is not None:
        O = int(vis_size.sum())
        lm = np.repeat(np.arange(L), vis_size[:L])
        vid_to_idx = {int(v): i for i, v in enumerate(scene.view_ids)}
        scene.obs_landmark = lm.astype(np.int32)
        scene.obs_view = np.array([vid_to_idx.get(int(v), INVALID) for v in vis_view[:O]], np.int32)
        scene.obs_uv = feat_pos[:O] if feat_pos is not None else np.zeros((O, 2))
        scene.obs_scale = feat_scale[:O] if feat_scale is not None else np.zeros(O)
        scene.obs_feature = vis_feat[:O].astype(np.int64) if vis_feat is not None else np.zeros(O, np.int64)
    return scene


# ===========================================================================
# AliceVision schema — export
# ===========================================================================


def _xform_props(mat44: np.ndarray | None):
    kids = []
    if mat44 is not None:
        kids = [
            WProp(".inherits", 1, 0, 1, np.array([1], np.uint8)),
            WProp(".ops", 1, 1, 1, np.array([0x30], np.uint8)),
            WProp(".vals", 1, 11, 16, mat44.T.reshape(-1)),
            WProp("isNotConstantIdentity", 1, 0, 1, np.array([1], np.uint8)),
        ]
    return WCompound(".xform", kids, meta=_METAS[8])


def save_abc(scene: SfMData, path: str) -> None:
    """Write an AliceVision-schema Alembic archive
    (ref: sfmDataIO/AlembicExporter.cpp)."""
    from . import io as sfmio

    cams = WObject("mvgCameras", _METAS[10], [_xform_props(None)])
    und = WObject(
        "mvgCamerasUndefined",
        _METAS[10],
        [_xform_props(None), WProp("visible", 1, 2, 1, np.array([0], np.int8))],
    )

    for vi in range(len(scene.view_ids)):
        ii = int(scene.view_intrinsic[vi])
        pi = int(scene.view_pose[vi])
        posed = pi != INVALID
        vid = int(scene.view_ids[vi])
        pose_id = int(scene.pose_ids[pi]) if posed else vid
        try:
            resec = int(scene.view_metadata[vi].get("resectionId", _UNDEF)) if vi < len(scene.view_metadata) else _UNDEF
        except (TypeError, ValueError):
            resec = _UNDEF
        label = f"camxform_{resec:05d}_{pose_id}__{vid}"

        mat = np.eye(4)
        if posed:
            T = np.eye(4)
            T[:3, :3] = scene.pose_R[pi]
            T[:3, 3] = -scene.pose_R[pi] @ scene.pose_c[pi]
            mat = np.linalg.inv(_M_FLIP @ T @ _M_FLIP)

        up_kids = []
        if posed:
            up_kids.append(WProp("mvg_poseLocked", 1, 0, 1,
                                 np.array([int(scene.pose_locked[pi])], np.uint8)))
        if vi < len(scene.view_paths) and scene.view_paths[vi]:
            up_kids.append(WProp("mvg_imagePath", 1, _POD_STR, 1, scene.view_paths[vi]))
        up_kids += [
            WProp("mvg_viewId", 1, 5, 1, np.array([vid], np.uint32)),
            WProp("mvg_poseId", 1, 5, 1, np.array([pose_id], np.uint32)),
            WProp("mvg_intrinsicId", 1, 5, 1,
                  np.array([int(scene.intrinsic_ids[ii]) if ii != INVALID else 0], np.uint32)),
            WProp("mvg_resectionId", 1, 5, 1, np.array([resec], np.uint32)),
        ]
        fid = int(scene.view_frames[vi]) if vi < len(scene.view_frames) else _UNDEF
        if fid != _UNDEF and fid >= 0:
            up_kids.append(WProp("mvg_frameId", 1, 5, 1, np.array([fid], np.uint32)))
        w, h = (int(scene.view_sizes[vi][0]), int(scene.view_sizes[vi][1]))
        up_kids += [
            WProp("mvg_sensorSizePix", 2, 5, 1, np.array([w, h], np.uint32)),
        ]
        core = np.zeros(16)
        if ii != INVALID:
            sw, sh = scene.sensor_size[ii]
            sw = sw if sw > 0 else 36.0
            sh = sh if sh > 0 else 24.0
            swp = max(w, h, 1)
            fx, fy = scene.scale[ii]
            pix2mm = sw / swp
            core[:6] = [
                fx * pix2mm,
                0.1 * w * pix2mm,
                0.1 * scene.offset[ii][0] * pix2mm,
                0.1 * h * pix2mm,
                0.1 * -scene.offset[ii][1] * pix2mm,
                fx / max(fy, 1e-9),
            ]
            core[10] = 5.6  # fStop default
            core[11] = 5.0  # focusDistance default
            core[13] = 1 / 48.0  # shutterClose
            core[14:16] = [0.1, 100000.0]
            nd = sfmio._N_DISTO_PARAMS.get(int(scene.disto_kind[ii]), 0)
            params = np.concatenate(
                [scene.scale[ii], scene.offset[ii], scene.disto[ii, :nd]]
            )
            extra = scene.intrinsic_extra[ii] if ii < len(scene.intrinsic_extra) else {}
            ck = int(scene.cam_kind[ii])
            from ..camera import models as cammod

            tname = "equidistant" if ck == cammod.CAM_EQUIDISTANT else "pinhole"
            dk = int(scene.disto_kind[ii])
            dname = sfmio._DISTO_TO_NAME.get(dk, "none")
            up_kids += [
                WProp("mvg_sensorSizeMm", 2, 11, 1, np.array([sw, sh])),
                WProp("mvg_intrinsicType", 1, _POD_STR, 1, tname),
                WProp("mvg_intrinsicInitializationMode", 1, _POD_STR, 1,
                      str(extra.get("initializationMode", "none"))),
                WProp("mvg_initialFocalLength", 1, 11, 1,
                      np.array([extra.get("initialFocalLength", -1.0)])),
                WProp("mvg_intrinsicSerialNumber", 1, _POD_STR, 1,
                      str(extra.get("serialNumber", ""))),
                WProp("mvg_intrinsicLocked", 1, 0, 1, np.array([0], np.uint8)),
                WProp("mvg_intrinsicPixelRatioLocked", 1, 0, 1, np.array([1], np.uint8)),
                WProp("mvg_intrinsicParams", 2, 11, 1, params),
                WProp("mvg_distortionType", 1, _POD_STR, 1, dname),
                WProp("mvg_undistortionType", 1, _POD_STR, 1, "none"),
            ]

        cam_obj = WObject(
            "camera_" + label,
            _METAS[6],
            [
                WCompound(
                    ".geom",
                    [
                        WProp(".core", 1, 11, 16, core),
                        WCompound(".userProperties", up_kids),
                    ],
                    meta=_METAS[7],
                )
            ],
        )
        xf = WObject(label, _METAS[10], [_xform_props(mat)], [cam_obj])
        (cams if posed else und).children.append(xf)

    # ----- point cloud -----
    L = len(scene.points)
    P = np.asarray(scene.points, np.float32) * np.array([1, -1, -1], np.float32)
    order = np.argsort(scene.obs_landmark, kind="stable") if len(scene.obs_landmark) else np.zeros(0, np.int64)
    vis_size = np.bincount(scene.obs_landmark, minlength=L).astype(np.uint32) if L else np.zeros(0, np.uint32)
    vid = scene.view_ids[scene.obs_view[order]] if len(order) else np.zeros(0)
    bnds = np.concatenate([P.min(0), P.max(0)]) if L else np.zeros(6)
    desc_codes = np.array(
        [_DESC_NAME_TO_CODE.get(t, 0) for t in scene.desc_types], np.uint32
    ) if scene.desc_types else np.zeros(L, np.uint32)
    if desc_codes.size != L:
        desc_codes = np.full(L, 10, np.uint32)
    pc_up = [
        WProp("mvg_describerType", 2, 5, 1, desc_codes),
        WProp("mvg_visibilitySize", 2, 5, 1, vis_size),
        WProp("mvg_visibilityViewId", 2, 5, 1, np.asarray(vid, np.uint32)),
        WProp("mvg_visibilityFeatId", 2, 5, 1,
              np.asarray(scene.obs_feature[order], np.uint32) if len(order) else np.zeros(0, np.uint32)),
        WProp("mvg_visibilityFeatPos", 2, 10, 1,
              np.asarray(scene.obs_uv[order], np.float32).reshape(-1) if len(order) else np.zeros(0, np.float32)),
        WProp("mvg_visibilityFeatScale", 2, 10, 1,
              np.asarray(scene.obs_scale[order], np.float32) if len(order) else np.zeros(0, np.float32)),
    ]
    shape = WObject(
        "particleShape1",
        _METAS[9],
        [
            WCompound(
                ".geom",
                [
                    WProp(".selfBnds", 1, 11, 6, bnds, meta=_METAS[2]),
                    WProp("P", 2, 10, 3, P, meta=_METAS[3]),
                    WProp(".pointIds", 2, 7, 1, np.arange(L, dtype=np.uint64), meta=_METAS[4]),
                    WCompound(
                        ".arbGeomParams",
                        [WProp("color", 2, 10, 3,
                               np.asarray(scene.colors, np.float32) / 255.0, meta=_METAS[1])]
                        if len(scene.colors) == L and L else [],
                    ),
                    WCompound(".userProperties", pc_up),
                ],
                meta=_METAS[5],
            )
        ],
    )
    cloud = WObject("mvgCloud", _METAS[10], [_xform_props(None)],
                    [WObject("mvgPointCloud", _METAS[10], [_xform_props(None)], [shape])])

    mvg_root = WObject(
        "mvgRoot",
        _METAS[10],
        [
            _xform_props(None),
            WProp("mvg_ABC_version", 2, 5, 1, np.array([1, 2, 11], np.uint32)),
            WProp("mvg_aliceVision_version", 2, 5, 1, np.array([3, 3, 0], np.uint32)),
            WProp("mvg_featuresFolders", 2, _POD_STR, 1, []),
            WProp("mvg_matchesFolders", 2, _POD_STR, 1, []),
        ],
        [cams, und, cloud, WObject("mvgAncestors", _METAS[10], [_xform_props(None)])],
    )
    top = WObject("ABC", b"", [], [mvg_root])
    write_archive(top, path)
