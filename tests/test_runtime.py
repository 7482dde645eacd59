"""Entry-point plumbing: compile-cache location, backend choices, the
multi-device dry run's device check and chip_smoke.py's GPU check."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from jpeg_decoder_tpu.utils import runtime
from jpeg_decoder_tpu.utils.config import DecodeConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    assert runtime.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper must not override it.
    assert jax.config.jax_compilation_cache_dir == "sentinel"


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                            restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".cache", "jax")
    assert runtime.compile_cache_dir() == want
    assert runtime.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


@pytest.mark.parametrize("field", ["entropy", "idct"])
def test_config_rejects_pallas(field):
    with pytest.raises(ValueError):
        DecodeConfig(**{field: "pallas"}).validate()


@pytest.mark.parametrize("flag", ["--entropy", "--idct"])
def test_cli_rejects_pallas(flag, capsys):
    from jpeg_decoder_tpu import cli

    with pytest.raises(SystemExit) as e:
        cli.build_argparser().parse_args([flag, "pallas", "x.jpg"])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_dryrun_multichip_raises_without_devices():
    import __graft_entry__ as graft

    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"needs {n} devices"):
        graft.dryrun_multichip(n)


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_chip_smoke_refuses_cpu_runtime():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=240)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=240)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
