"""The port's settings against ``tests/test_settings.py``'s ten cases: the
same keys, defaults and ``config`` guards as the reference package's, with
the port's device names (``BACKEND`` is ``cuda`` or ``cpu``), and the keys
the pipeline reads at each call resolved at the call."""

from __future__ import annotations

import pandas as pd
import pytest

from fm_returnprediction_tpu import settings as jax_settings
from fm_returnprediction_tpu_torch import settings
from fm_returnprediction_tpu_torch.settings import config, read_env_file

pytestmark = pytest.mark.torch_port

_CLEAR = ("DATA_DIR", "OUTPUT_DIR", "START_DATE", "END_DATE", "BACKEND")


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    for key in _CLEAR:
        monkeypatch.delenv(key, raising=False)


def test_default_sample_period():
    assert config("START_DATE") == pd.Timestamp("1964-01-01")
    assert config("END_DATE") == pd.Timestamp("2013-12-31")
    assert config("START_DATE") == jax_settings.config("START_DATE")
    assert config("END_DATE") == jax_settings.config("END_DATE")


def test_directory_layout():
    data_dir = config("DATA_DIR")
    assert config("RAW_DATA_DIR") == data_dir / "raw"
    assert config("PROCESSED_DATA_DIR") == data_dir / "processed"
    assert config("MANUAL_DATA_DIR") == data_dir / "manual"
    # both packages sit in one repo: the same default tree
    for key in ("DATA_DIR", "RAW_DATA_DIR", "PROCESSED_DATA_DIR", "MANUAL_DATA_DIR",
                "OUTPUT_DIR"):
        assert config(key) == jax_settings.config(key), key


def test_backend_key_exists():
    assert config("BACKEND") == "cuda"
    assert config("BACKEND") in set(settings.BACKENDS)


@pytest.mark.parametrize("mod", [settings, jax_settings], ids=["port", "jax"])
def test_double_default_guard(mod):
    with pytest.raises(ValueError, match="Default for START_DATE"):
        mod.config("START_DATE", default="1999-01-01")
    with pytest.raises(ValueError, match="Default for DTYPE"):
        mod.config("DTYPE", default="float64")


@pytest.mark.parametrize("mod", [settings, jax_settings], ids=["port", "jax"])
def test_type_change_guard(mod):
    with pytest.raises(ValueError, match="Type for START_DATE"):
        mod.config("START_DATE", cast=str)
    with pytest.raises(ValueError, match="Type for MESH_DEVICES"):
        mod.config("MESH_DEVICES", cast=str)
    assert mod.config("MESH_DEVICES", cast=int) == 1   # re-asserting is allowed


def test_unknown_key_raises():
    with pytest.raises(KeyError):
        config("NO_SUCH_KEY_EVER")


def test_unknown_key_with_default():
    assert config("NO_SUCH_KEY_EVER", default="fallback") == "fallback"
    assert config("NO_SUCH_KEY_EVER", default="7", cast=int) == 7


def test_read_env_file(tmp_path):
    env = tmp_path / ".env"
    env.write_text("# comment\nFOO=bar\nQUOTED='baz'\n\nBAD_LINE\n")
    values = read_env_file(env)
    assert values == {"FOO": "bar", "QUOTED": "baz"}
    assert values == jax_settings.read_env_file(env)


def test_create_dirs(tmp_path, monkeypatch):
    for key in ("DATA_DIR", "RAW_DATA_DIR", "PROCESSED_DATA_DIR",
                "MANUAL_DATA_DIR", "OUTPUT_DIR"):
        monkeypatch.setitem(settings.d, key, tmp_path / key.lower())
    settings.create_dirs()
    assert (tmp_path / "raw_data_dir").is_dir()
    assert (tmp_path / "output_dir").is_dir()
    # without an override the tree follows DATA_DIR/OUTPUT_DIR at the call
    for key in ("DATA_DIR", "RAW_DATA_DIR", "PROCESSED_DATA_DIR",
                "MANUAL_DATA_DIR", "OUTPUT_DIR"):
        monkeypatch.delitem(settings.d, key)
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "later"))
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "later_out"))
    settings.create_dirs()
    assert (tmp_path / "later" / "manual").is_dir()
    assert (tmp_path / "later_out").is_dir()


def test_apply_backend_cuda_cpu_and_validation(monkeypatch):
    assert settings.apply_backend("cpu") == "cpu"
    assert settings.apply_backend("CUDA") == "cuda"
    assert settings.apply_backend() == "cuda"            # the BACKEND default
    monkeypatch.setenv("BACKEND", "cpu")
    assert settings.apply_backend() == "cpu"             # read at the call
    with pytest.raises(ValueError, match="BACKEND"):
        settings.apply_backend("tpu")
    with pytest.raises(ValueError, match="BACKEND"):
        jax_settings.apply_backend("cuda")               # each package's own names


def test_live_keys_are_read_at_the_call(monkeypatch, tmp_path):
    """The keys the pipeline reads at each call follow the environment
    after import, with the reference's defaults when unset."""
    from fm_returnprediction_tpu_torch.data.prepared import prepared_enabled
    from fm_returnprediction_tpu_torch.parallel.mesh import mesh_devices_setting
    from fm_returnprediction_tpu_torch.pipeline import (
        _default_raw_data_dir,
        _resolve_turnover,
        resolve_dtype,
    )

    for key in ("DTYPE", "INCLUDE_TURNOVER", "PREPARED_CACHE", "MESH_DEVICES"):
        monkeypatch.delenv(key, raising=False)
    assert (str(resolve_dtype()), _resolve_turnover(None), prepared_enabled(),
            mesh_devices_setting()) == ("torch.float32", False, True, 1)
    assert {k: jax_settings.d[k] for k in ("DTYPE", "INCLUDE_TURNOVER", "PREPARED_CACHE",
                                           "MESH_DEVICES")} == {
        "DTYPE": "float32", "INCLUDE_TURNOVER": 0, "PREPARED_CACHE": 1, "MESH_DEVICES": 1}
    monkeypatch.setenv("DTYPE", "float64")
    monkeypatch.setenv("INCLUDE_TURNOVER", "1")
    monkeypatch.setenv("PREPARED_CACHE", "0")
    monkeypatch.setenv("MESH_DEVICES", " ")
    monkeypatch.setenv("DATA_DIR", str(tmp_path))
    assert (str(resolve_dtype()), _resolve_turnover(None), prepared_enabled(),
            mesh_devices_setting()) == ("torch.float64", True, False, 1)
    assert _default_raw_data_dir() == tmp_path / "raw"
