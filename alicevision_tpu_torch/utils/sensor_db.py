"""Camera sensor-width database.

A copy of `alicevision_tpu/utils/sensor_db.py`; the table it reads is the
port's own copy, `alicevision_tpu_torch/data/camera_sensors.db.gz`.

Counterpart of the reference's sensor DB (ref:
src/aliceVision/sensorDB/parseDatabase.hpp + cameraSensors.db — a
"make;model;width_mm" CSV). The full ~7.5k-row factual table of sensor
widths ships with the package (data/camera_sensors.db.gz — measurement
data compiled from public device databases, same provenance as the
reference's file; carried as data, not code). A compact built-in table
covers the lookup if the data file is missing, and any CSV in the same
format can be loaded explicitly.
"""

from __future__ import annotations

import gzip
import os

# Minimal built-in fallback table (sensor width in mm). Matching is
# case-insensitive substring on "make model".
BUILTIN_SENSORS = {
    "canon eos 5d mark iii": 36.0,
    "canon eos 5d mark iv": 36.0,
    "canon eos r5": 36.0,
    "canon eos 80d": 22.3,
    "nikon d850": 35.9,
    "nikon d750": 35.9,
    "nikon d3400": 23.5,
    "sony ilce-7m3": 35.8,
    "sony ilce-7rm4": 35.7,
    "sony ilce-6000": 23.5,
    "fujifilm x-t3": 23.5,
    "fujifilm x-t4": 23.5,
    "dji fc330": 6.25,
    "dji fc6310": 13.2,
    "dji zemuse x7": 23.5,
    "apple iphone 12": 5.7,
    "apple iphone 13": 7.0,
    "apple iphone 14": 7.6,
    "gopro hero8 black": 6.17,
    "gopro hero10 black": 6.17,
}

_DEFAULT_WIDTH_MM = 36.0


def _parse_lines(lines) -> dict:
    db = {}
    for line in lines:
        parts = line.strip().split(";")
        if len(parts) < 3:
            continue
        make, model, width = parts[0], parts[1], parts[2]
        try:
            w = float(width)
        except ValueError:
            continue
        if w > 0:
            db[f"{make} {model}".strip().lower()] = w
    return db


def parse_database(path: str) -> dict:
    """Parse a 'Make;Model;WidthMM[;source]' CSV into {key: width_mm}."""
    with open(path, "r", errors="ignore") as f:
        return _parse_lines(f)


_SHIPPED = None


def shipped_database() -> dict:
    """The full shipped sensor table (lazy-loaded, cached)."""
    global _SHIPPED
    if _SHIPPED is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "data",
            "camera_sensors.db.gz",
        )
        if os.path.exists(path):
            with gzip.open(path, "rt", errors="ignore") as f:
                _SHIPPED = _parse_lines(f)
        else:  # data file stripped from the install — built-ins only
            _SHIPPED = {}
    return _SHIPPED


def sensor_width_mm(make: str, model: str, db: dict | None = None) -> tuple[float, bool]:
    """Look up the sensor width; returns (width_mm, found)."""
    table = dict(BUILTIN_SENSORS)
    table.update(shipped_database())
    if db:
        table.update(db)
    key = f"{make} {model}".strip().lower()
    if key in table:
        return table[key], True
    model_l = model.strip().lower()
    for k, v in table.items():
        if model_l and model_l in k:
            return v, True
    return _DEFAULT_WIDTH_MM, False


def focal_px_from_exif(meta: dict, width_px: int, db: dict | None = None) -> tuple[float, bool]:
    """Focal in pixels from EXIF focal_mm + sensor width; falls back to
    1.2 * max dimension like the reference's unknown-intrinsic default."""
    focal_mm = meta.get("focal_mm")
    if focal_mm:
        w_mm, found = sensor_width_mm(meta.get("make", ""), meta.get("model", ""), db)
        return focal_mm / w_mm * width_px, found
    return 1.2 * width_px, False
