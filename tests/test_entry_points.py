"""Entry points that need a GPU fail loudly without one; the compile
cache honours JAX_COMPILATION_CACHE_DIR."""

import jax
import pytest

from halo2_aes_tpu.utils import cache


@pytest.fixture
def accelerator_config(monkeypatch, tmp_path):
    """Pretend the backend is a GPU; restore JAX's cache settings after."""
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / "xla_cache"))
    yield tmp_path
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_uses_env_dir(monkeypatch, accelerator_config):
    env_dir = str(accelerator_config / "from_env")
    monkeypatch.setenv(cache.ENV_VAR, env_dir)
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache()
    # JAX reads the variable itself: no other path is set
    assert jax.config.jax_compilation_cache_dir == before
    assert not (accelerator_config / "xla_cache").exists()


def test_compile_cache_default_dir_without_env(monkeypatch,
                                               accelerator_config):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
    assert (accelerator_config / "xla_cache").is_dir()


def test_compile_cache_stays_off_on_cpu():
    assert not cache.enable_compile_cache()
    assert cache.DEFAULT_DIR.endswith("ptau/xla_cache")


@pytest.mark.parametrize("entry", ["chip_smoke", "bench"])
def test_entry_point_raises_without_gpu(entry, capsys):
    import importlib

    mod = importlib.import_module(entry)
    with pytest.raises(SystemExit) as e:
        if entry == "chip_smoke":
            mod.device_phase(1)
        else:
            mod.main()
    assert "needs a GPU" in str(e.value.code) and "'cpu'" in str(e.value.code)
    assert capsys.readouterr().out == ""
