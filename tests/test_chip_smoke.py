"""chip_smoke.py on the CPU: its device gate, its phase selection, and
every phase rehearsed at a tiny deployment (the CPU standing in for the
card, four virtual CPU devices for the mesh)."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from pir_tpu.testing.params import tiny_pir_params  # noqa: E402


def test_cpu_only_process_fails_without_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_alone_in_a_directory_fails_without_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text()
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize(
    "argv,phases", [([], ["a", "b", "c"]), (["--four-cards"], ["d"])]
)
def test_phase_selection(argv, phases):
    assert chip_smoke.phases_for(chip_smoke.parse_args(argv)) == phases


def test_headline_deployment_shape():
    p = chip_smoke.headline_params()
    assert (p.num_items, p.bytes_per_item, p.dimensions) == (1 << 20, 288, (162, 162))
    assert p.encryption_params.poly_modulus_degree == 4096
    assert p.reply_limbs() == 1


@pytest.fixture(scope="module")
def stack():
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
    return chip_smoke.Stack(params, seed=3)


def test_phases_a_b_c_rehearsed_on_cpu(stack):
    chip_smoke.phase_a(stack, platform="cpu")
    chip_smoke.phase_b(stack, batch=4)
    chip_smoke.phase_c(stack, card="cpu")


def test_phase_d_rehearsed_on_four_cpu_devices(stack):
    chip_smoke.phase_d(stack, jax.devices()[:4], card="cpu")
