"""Project configuration from ``.env`` files and environment variables.

The reference package's settings (same keys, same defaults, the same
``config`` guards), with the port's device names:

- ``BACKEND``      — ``"cuda"`` (default) or ``"cpu"``: the compute device
  of the entry points that follow the setting (``apply_backend``);
- ``MESH_DEVICES`` — the 1-D compute mesh: ``1`` (default) = no mesh,
  ``0`` = every device, ``N`` = exactly N (``parallel.mesh``);
- ``DTYPE``        — ``"float32"`` (default) or ``"float64"``;
- ``INCLUDE_TURNOVER`` — ``1`` adds the opt-in Turnover characteristic;
- ``PREPARED_CACHE`` — ``0`` turns the prepared-inputs slot off
  (``data.prepared``).

Precedence: OS environment > ``.env`` file in ``BASE_DIR`` > in-code default.

Two kinds of key. The reference's sample and credential keys are read once,
at import, into ``d``. The keys the pipeline reads at each call
(``LIVE_KEYS``: ``DATA_DIR`` and the directories under it, ``OUTPUT_DIR``,
``BACKEND``, ``MESH_DEVICES``, ``DTYPE``, ``INCLUDE_TURNOVER``,
``PREPARED_CACHE``) are resolved by :func:`config` at the call, so a
variable set after import is seen; each is read through ``config`` in one
place of the package. A value placed in ``d`` overrides either kind.

``config(key)`` keeps the reference's guards: asking for a defined key
while passing a ``default`` raises, and a ``cast`` that would change the
type of a defined key raises.
"""

from __future__ import annotations

import os
from pathlib import Path
from platform import system

import pandas as pd

__all__ = ["LIVE_KEYS", "apply_backend", "config", "create_dirs", "d", "get_os",
           "if_relative_make_abs", "read_env_file"]

BACKENDS = ("cuda", "cpu")


def get_os() -> str:
    """OS family tag; 'nix' for Linux/macOS."""
    return {"Windows": "windows", "Darwin": "nix", "Linux": "nix"}.get(system(), "unknown")


def read_env_file(path: Path) -> dict[str, str]:
    """Parse a ``KEY=VALUE`` .env file (comments and blank lines ignored)."""
    values: dict[str, str] = {}
    if not path.exists():
        return values
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, raw = line.partition("=")
        values[key.strip()] = raw.strip().strip("'\"")
    return values


_BASE_DIR = Path(__file__).absolute().parent.parent
_ENV_FILE = read_env_file(_BASE_DIR / ".env")


def _env(key: str, default=None, cast=None):
    raw = os.environ.get(key, _ENV_FILE.get(key, default))
    if cast is not None and raw is not None:
        return cast(raw)
    return raw


def if_relative_make_abs(path) -> Path:
    """Resolve ``path`` against BASE_DIR unless already absolute."""
    path = Path(path)
    return path.resolve() if path.is_absolute() else (_BASE_DIR / path).resolve()


def _int(default: str):
    """A cast to int that reads an empty value as ``default``."""
    return lambda raw: int(str(raw).strip() or default)


d: dict = {}
d["OS_TYPE"] = get_os()
d["BASE_DIR"] = _BASE_DIR
d["WRDS_USERNAME"] = _env("WRDS_USERNAME", default="")
d["NASDAQ_API_KEY"] = _env("NASDAQ_API_KEY", default="")
d["START_DATE"] = _env("START_DATE", default="1964-01-01", cast=pd.to_datetime)
d["END_DATE"] = _env("END_DATE", default="2013-12-31", cast=pd.to_datetime)
d["USER"] = _env("USER", default="")

# key → its value at the call: (raw default, cast) from the environment, or
# a derivation from another key. The one table of the settings the pipeline
# reads at each call.
LIVE_KEYS = {
    "DATA_DIR": ("_data", if_relative_make_abs),
    "RAW_DATA_DIR": lambda: config("DATA_DIR") / "raw",
    "PROCESSED_DATA_DIR": lambda: config("DATA_DIR") / "processed",
    "MANUAL_DATA_DIR": lambda: config("DATA_DIR") / "manual",
    "OUTPUT_DIR": ("_output", if_relative_make_abs),
    "BACKEND": ("cuda", lambda raw: str(raw).strip().lower()),
    "MESH_DEVICES": ("1", _int("1")),
    "DTYPE": ("float32", str),
    # the opt-in 16th characteristic (Turnover_{-1,-12}); 0 keeps the
    # reference's 15 variables
    "INCLUDE_TURNOVER": ("0", _int("0")),
    # the prepared-inputs slot under <raw_dir>/_prepared; 0 disables
    # reading and writing it
    "PREPARED_CACHE": ("1", _int("1")),
}


def _live(key: str):
    entry = LIVE_KEYS[key]
    if callable(entry):
        return entry()
    default, cast = entry
    return _env(key, default=default, cast=cast)


def config(*args, **kwargs):
    """Guarded accessor for configuration values.

    Keys defined here (in ``d`` or ``LIVE_KEYS``) may not be given a new
    default, and a ``cast`` may re-assert but not change their type. Other
    keys fall back to the environment/.env lookup with the given
    ``default``/``cast``, and raise ``KeyError`` when absent."""
    key = args[0]
    default = kwargs.get("default", None)
    cast = kwargs.get("cast", None)
    if key in d or key in LIVE_KEYS:
        var = d[key] if key in d else _live(key)
        if default is not None:
            raise ValueError(f"Default for {key} already exists. Check settings.py.")
        if cast is not None and type(cast(var)) is not type(var):
            raise ValueError(f"Type for {key} is already set. Check settings.py.")
        return var
    var = _env(key, default=default, cast=cast)
    if var is None:
        raise KeyError(f"{key} not found in settings, environment, or .env file.")
    return var


def apply_backend(backend: str | None = None) -> str:
    """The compute device named by ``backend`` (else the ``BACKEND``
    setting), validated: ``"cuda"`` or ``"cpu"``. Returns the name; the
    entry points pass it on as their ``device``. Nothing else is set:
    PyTorch takes the device per call."""
    backend = (backend or config("BACKEND")).strip().lower()
    if backend not in BACKENDS:
        raise ValueError(f"BACKEND must be 'cuda' or 'cpu', got {backend!r}")
    return backend


def create_dirs() -> None:
    """Create the regenerable data/output directory tree."""
    for key in ("DATA_DIR", "RAW_DATA_DIR", "PROCESSED_DATA_DIR", "MANUAL_DATA_DIR",
                "OUTPUT_DIR"):
        config(key).mkdir(parents=True, exist_ok=True)


if __name__ == "__main__":
    create_dirs()
