"""Checks that need the card: the same functions chip_smoke.py runs, at
the sizes it runs them. They skip without a GPU; on the card run

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import pathlib
import sys

import jax
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def f32(gpu_devices):
    """The shipping precision, whatever the test session's x64 default."""
    with jax.enable_x64(False):
        yield gpu_devices


def test_device_and_nvidia_smi(f32):
    chip_smoke.device_phase()


def test_offline_trajectory_on_gpu(f32, tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    chip_smoke.offline_phase()


def test_structured_matches_dense_on_gpu(f32):
    chip_smoke.qp_parity_phase(batch=256)


def test_gpu_matches_host_cpu(f32):
    chip_smoke.device_parity_phase(batch=64)
