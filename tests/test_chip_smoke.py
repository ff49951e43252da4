"""The parts of chip_smoke.py and the start-up helpers that run without a
GPU: the refusal, the compile-cache rule, the nvidia-smi parser and the
phase selection of --four-cards."""

import os
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from opengpc_tpu.utils.device import setup_compile_cache  # noqa: E402


def test_refuses_without_gpu(capsys):
    """On the CPU the script exits non-zero before any work and prints no
    result line."""
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert "no GPU" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture
def cache_dir_restored():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_wins(cache_dir_restored):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: nothing
    is set in code."""
    before = jax.config.jax_compilation_cache_dir
    got = setup_compile_cache({"JAX_COMPILATION_CACHE_DIR": "/some/dir"})
    assert got == "/some/dir"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_repo_path(cache_dir_restored):
    """Unset, the cache goes to the fixed <repo>/.jax_cache — never a
    temp, pid or time-based path — and .gitignore lists it."""
    want = os.path.join(REPO, ".jax_cache")
    assert setup_compile_cache({}) == want
    assert jax.config.jax_compilation_cache_dir == want
    assert setup_compile_cache({"JAX_COMPILATION_CACHE_DIR": ""}) == want
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_parse_smi():
    assert chip_smoke.parse_smi("NVIDIA H100 80GB HBM3, 700.00 W\n") == [
        ("NVIDIA H100 80GB HBM3", "700.00 W")]
    four = "\n".join(["NVIDIA H100 80GB HBM3, 500.00 W"] * 4)
    assert chip_smoke.parse_smi(four) == [
        ("NVIDIA H100 80GB HBM3", "500.00 W")] * 4
    assert chip_smoke.parse_smi("") == []


def test_four_cards_selects_only_its_phases():
    one = chip_smoke.select_phases(False)
    four = chip_smoke.select_phases(True)
    assert four == chip_smoke.FOUR_CARD_PHASES
    assert one == chip_smoke.PHASES
    assert not set(one) & set(four)
    assert {"batch_mesh", "sharded_frame", "global_compact", "mesh_2d",
            "train_mesh"} == set(four)
    for name in one + four:
        assert callable(getattr(chip_smoke, f"phase_{name}"))


def test_device_line_names_the_backend():
    from opengpc_tpu.utils.device import device_line

    line = device_line()
    dev = jax.devices()[0]
    assert line == (f"backend={dev.platform} kind={dev.device_kind} "
                    f"count={len(jax.devices())}")
