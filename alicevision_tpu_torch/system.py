"""System layer: logger, timers, memory info, hardware context, progress.

Port of `alicevision_tpu/system.py`: the same logger levels and
`ALICEVISION_LOG_*` override, `Timer`, `memory_info`, `HardwareContext`,
`hardware_report` and `ProgressDisplay`; `accelerator_info` probes the CUDA
devices through `torch.cuda` where the JAX package lists `jax.devices()`.
Counterpart of the reference's `system/` module
(ref: src/aliceVision/system/Logger.hpp:23-36, Logger.cpp:130 env override,
Timer.hpp, MemoryInfo.hpp, hardwareContext.hpp:14-35, ProgressDisplay.hpp)
and the `gpu/` capability probe (ref: src/aliceVision/gpu/gpu.hpp:21-27).
As in the JAX package, the CLI does not call `hardware_report`.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

__all__ = [
    "logger",
    "set_log_level",
    "Timer",
    "memory_info",
    "HardwareContext",
    "accelerator_info",
    "hardware_report",
    "ProgressDisplay",
]

# ---------------------------------------------------------------------------
# Logger — levels mirror ALICEVISION_LOG_* (trace..fatal); the env override
# keeps the reference's variable name so existing launch scripts carry over
# (ref: system/Logger.cpp:130).
# ---------------------------------------------------------------------------

TRACE = 5
logging.addLevelName(TRACE, "TRACE")
FATAL = logging.CRITICAL

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": FATAL,
}

logger = logging.getLogger("alicevision_tpu_torch")


def _init_logger() -> None:
    if logger.handlers:
        return
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter("[%(asctime)s.%(msecs)03d][%(levelname)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(h)
    env = os.environ.get("AV_TPU_LOG_LEVEL") or os.environ.get("ALICEVISION_LOG_LEVEL")
    logger.setLevel(_LEVELS.get((env or "info").lower(), logging.INFO))


def set_log_level(level: str) -> None:
    """Set the verbosity; accepts the reference's level names (trace..fatal)."""
    _init_logger()
    if level.lower() not in _LEVELS:
        raise ValueError(f"unknown log level '{level}' (want one of {sorted(_LEVELS)})")
    logger.setLevel(_LEVELS[level.lower()])


_init_logger()


# ---------------------------------------------------------------------------
# Timer (ref: system/Timer.hpp)
# ---------------------------------------------------------------------------


class Timer:
    """Wall-clock timer; also a context manager that logs on exit."""

    def __init__(self, label: Optional[str] = None):
        self.label = label
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def elapsed_ms(self) -> float:
        return 1e3 * self.elapsed()

    def __enter__(self) -> "Timer":
        self.reset()
        return self

    def __exit__(self, *exc) -> None:
        if self.label is not None:
            logger.info("%s took %.3fs", self.label, self.elapsed())


# ---------------------------------------------------------------------------
# Memory info (ref: system/MemoryInfo.hpp)
# ---------------------------------------------------------------------------


@dataclass
class MemoryInfo:
    total_ram: int
    free_ram: int
    available_ram: int
    total_swap: int
    free_swap: int


def memory_info() -> MemoryInfo:
    """Read /proc/meminfo (bytes); zeros when unavailable."""
    vals = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                vals[k.strip()] = int(rest.split()[0]) * 1024
    except OSError:
        pass
    return MemoryInfo(
        total_ram=vals.get("MemTotal", 0),
        free_ram=vals.get("MemFree", 0),
        available_ram=vals.get("MemAvailable", vals.get("MemFree", 0)),
        total_swap=vals.get("SwapTotal", 0),
        free_swap=vals.get("SwapFree", 0),
    )


# ---------------------------------------------------------------------------
# Hardware context (ref: system/hardwareContext.hpp:14-35 — user-settable
# caps on cores/RAM that schedulers must respect)
# ---------------------------------------------------------------------------


@dataclass
class HardwareContext:
    max_memory_available: Optional[int] = None  # bytes
    max_cores_available: Optional[int] = None

    @staticmethod
    def from_args(args) -> "HardwareContext":
        """Build from parsed `av` CLI args (shared flags)."""
        return HardwareContext(
            max_memory_available=getattr(args, "maxMemoryAvailable", None),
            max_cores_available=getattr(args, "maxCoresAvailable", None),
        )

    def usable_memory(self) -> int:
        avail = memory_info().available_ram
        if self.max_memory_available:
            return min(avail, self.max_memory_available)
        return avail

    def usable_cores(self) -> int:
        cores = os.cpu_count() or 1
        if self.max_cores_available:
            return min(cores, self.max_cores_available)
        return cores


def accelerator_info() -> list[dict]:
    """Per-device accelerator report — the `gpu/` probe analog
    (ref: src/aliceVision/gpu/gpu.hpp:21-27) over the CUDA devices torch
    sees: id, platform, name and memory. Empty without a card."""
    try:
        import torch

        if not torch.cuda.is_available():
            return []
        out = []
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            out.append({
                "id": i,
                "platform": "gpu",
                "kind": props.name,
                "hbm_bytes": int(props.total_memory),
            })
        return out
    except Exception:  # noqa: BLE001 — an unusable CUDA runtime is a valid state
        return []


def hardware_report(hwc: Optional[HardwareContext] = None) -> str:
    """Multi-line banner printed by every tool (ref: cmdline.cpp:13-26)."""
    hwc = hwc or HardwareContext()
    mem = memory_info()
    lines = [
        "Hardware:",
        f"  cores: {os.cpu_count()} (usable: {hwc.usable_cores()})",
        f"  ram:   {mem.total_ram / 2**30:.1f} GiB total, "
        f"{mem.available_ram / 2**30:.1f} GiB available "
        f"(usable: {hwc.usable_memory() / 2**30:.1f} GiB)",
    ]
    for d in accelerator_info():
        hbm = f", hbm {d['hbm_bytes'] / 2**30:.1f} GiB" if "hbm_bytes" in d else ""
        lines.append(f"  accel[{d['id']}]: {d['platform']} {d['kind']}{hbm}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Progress display (ref: system/ProgressDisplay.hpp)
# ---------------------------------------------------------------------------


class ProgressDisplay:
    """Logged progress ticks at ~`step_pct` granularity."""

    def __init__(self, total: int, label: str = "", step_pct: float = 10.0):
        self.total = max(int(total), 1)
        self.label = label
        self.count = 0
        self._next = 0.0
        self._step = step_pct

    def tick(self, n: int = 1) -> None:
        self.count += n
        pct = 100.0 * self.count / self.total
        if pct >= self._next or self.count >= self.total:
            logger.info("%s %d/%d (%.0f%%)", self.label, self.count, self.total, min(pct, 100.0))
            self._next = (pct // self._step + 1) * self._step

    def __iter__(self):
        # wrap: for x in ProgressDisplay.over(seq, ...)
        raise TypeError("use ProgressDisplay.over(iterable, label=...)")

    @staticmethod
    def over(iterable, label: str = "", step_pct: float = 10.0):
        items = list(iterable)
        prog = ProgressDisplay(len(items), label, step_pct)
        for x in items:
            yield x
            prog.tick()
