"""chip_smoke.py's phases at a small size on the CPU, with the device
check passed as an argument: the script's control flow and comparisons
are exercised here, its speed only on the card."""

import importlib.util
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, RES = 1 << 14, 128


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exported(smoke):
    check = smoke.Checks()
    vis, image, warm = smoke.phase_export(N, RES, check)
    return vis, image, check


def test_main_exits_nonzero_without_gpu(smoke, capsys):
    with pytest.raises(SystemExit) as e:
        smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_device_phase_and_platform_check(smoke, capsys):
    smoke.require_platform("cpu")  # the check passes for the backend present
    smoke.phase_device()
    out = capsys.readouterr().out
    assert "nvidia-smi --query-gpu=name,power.limit:" in out
    assert "device_kind:" in out
    assert "host packages:" in out


def test_export_and_reference_phases(smoke, exported):
    vis, image, check = exported
    assert image.shape == (RES, RES, 2) and np.isfinite(image).all()
    stats, ref = smoke.compare_with_scatter(vis, image, check,
                                            piece=1 << 12)
    assert ref.shape == image.shape
    assert stats["corr"] > 0.999
    assert not check.failed, check.failed


def test_interactive_phase(smoke, exported):
    vis, image, _ = exported
    check = smoke.Checks()
    out = smoke.phase_interactive(vis, image, check, n_change=3)
    assert len(out["frame_times"]) == 3
    assert all(0 < c <= 1.0 + 1e-9 for c in out["coverage"])
    assert not check.failed, check.failed


def test_surface_phase(smoke):
    check = smoke.Checks()
    stats, vis = smoke.phase_surface(N, RES, check)
    assert stats["coverage_mismatch"] == 0
    assert not check.failed, check.failed


def test_cli_phase(smoke):
    check = smoke.Checks()
    vs = smoke.phase_cli(["test://20000", "-q", "test-quantity",
                          "--render-mode", "bivariate", "-r", "64"], check)
    assert len(vs) == 1
    assert not check.failed, check.failed


def test_four_card_phase_on_virtual_devices(smoke):
    check = smoke.Checks()
    smoke.phase_four_cards(N, RES, check, n_devices=4)
    assert not check.failed, check.failed


def test_checks_record_misses(smoke, capsys):
    check = smoke.Checks()
    check("a", 1.0, True, "<= 2")
    check("b", 3.0, False, "<= 2")
    assert check.failed == ["b"]
    assert "MISSED" in capsys.readouterr().out
