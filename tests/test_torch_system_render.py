"""The port's `system.py` and `utils/render.py` against the JAX package's, on
the CPU.

`system.py`: the reference's log levels and their names, `Timer`,
`memory_info`, `HardwareContext`, the banner and `ProgressDisplay`'s ticks
as the JAX package gives them; `accelerator_info` lists the CUDA devices
torch sees (none here). `utils/render.py` is a host copy: its textures,
rotations, renders and test dataset are the JAX package's arrays, byte for
byte.
"""

import argparse
import logging
import os

import numpy as np
import pytest
import torch

from alicevision_tpu import system as jsys
from alicevision_tpu.utils import render as jrender
from alicevision_tpu_torch import system as tsys
from alicevision_tpu_torch.utils import render as trender

torch.set_num_threads(1)


def test_log_levels_match():
    assert tsys._LEVELS == jsys._LEVELS and tsys.TRACE == jsys.TRACE == 5
    try:
        for name in ("trace", "debug", "WARNING", "fatal"):
            tsys.set_log_level(name)
            jsys.set_log_level(name)
            assert tsys.logger.level == jsys.logger.level
        with pytest.raises(ValueError, match="unknown log level"):
            tsys.set_log_level("loud")
    finally:
        tsys.set_log_level("info")
        jsys.set_log_level("info")
    assert tsys.logger.name == "alicevision_tpu_torch" and tsys.logger.handlers


def test_timer_progress_and_banner(caplog):
    with caplog.at_level(logging.INFO, logger="alicevision_tpu_torch"):
        with tsys.Timer("step") as t:
            pass
        assert t.elapsed() >= 0 and t.elapsed_ms() >= 0
        assert list(tsys.ProgressDisplay.over(range(7), "views", step_pct=25.0)) == list(range(7))
    got = [r.getMessage() for r in caplog.records if r.name == "alicevision_tpu_torch"]
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="alicevision_tpu"):
        with jsys.Timer("step"):
            pass
        list(jsys.ProgressDisplay.over(range(7), "views", step_pct=25.0))
    want = [r.getMessage() for r in caplog.records if r.name == "alicevision_tpu"]
    assert got[0].startswith("step took") and got[1:] == want[1:] and len(got) == len(want)
    with pytest.raises(TypeError):
        iter(tsys.ProgressDisplay(3))
    lines, jlines = tsys.hardware_report().splitlines(), jsys.hardware_report().splitlines()
    assert lines[:2] == jlines[:2] and lines[2].split("(")[0] == jlines[2].split("(")[0]


def test_memory_and_hardware_context():
    m, j = tsys.memory_info(), jsys.memory_info()
    assert (m.total_ram, m.total_swap) == (j.total_ram, j.total_swap) and m.total_ram > 0
    args = argparse.Namespace(maxMemoryAvailable=1 << 20, maxCoresAvailable=1)
    h, jh = tsys.HardwareContext.from_args(args), jsys.HardwareContext.from_args(args)
    assert (h.usable_memory(), h.usable_cores()) == (jh.usable_memory(), jh.usable_cores()) == (1 << 20, 1)
    assert tsys.HardwareContext().usable_cores() == os.cpu_count()


def test_accelerator_info_lists_cuda_devices():
    info = tsys.accelerator_info()
    assert len(info) == (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    for i, d in enumerate(info):
        assert d["id"] == i and d["platform"] == "gpu" and d["hbm_bytes"] > 0


def test_render_arrays_equal():
    np.testing.assert_array_equal(trender.procedural_texture(3, 128), jrender.procedural_texture(3, 128))
    for c, tgt, up in (((2.0, 1.0, 5.0), (0, 0, 0), (0, 0, 1)), ((0.0, 0.0, 5.0), (0, 0, 0), (0, 0, 1))):
        np.testing.assert_array_equal(trender.look_at(c, tgt, up), jrender.look_at(c, tgt, up))
    K = np.array([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]])
    c = np.array([1.5, 0.5, 4.0])
    R = trender.look_at(c, (0, 0, 0), up=(0, 1, 0))
    for a, b in zip(trender.render_two_plane_scene(R, c, K, (160, 120), seed=2),
                    jrender.render_two_plane_scene(R, c, K, (160, 120), seed=2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_make_test_dataset_equal(tmp_path):
    got = trender.make_test_dataset(str(tmp_path / "port"), n_views=2, wh=(96, 72), focal=80.0, seed=1)
    want = jrender.make_test_dataset(str(tmp_path / "jax"), n_views=2, wh=(96, 72), focal=80.0, seed=1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    from alicevision_tpu_torch.image.io import read_image

    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == ["view_000.png", "view_001.png"]
    for n in names:
        np.testing.assert_array_equal(read_image(str(tmp_path / "port" / n)), read_image(str(tmp_path / "jax" / n)))
