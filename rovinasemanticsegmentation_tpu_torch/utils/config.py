"""JSON configuration with command-line overrides.

The port's copy of ``rovinasemanticsegmentation_tpu/utils/config.py``, kept so that
the port imports nothing of the JAX package.

Capability parity with the reference ``Utils::Config``
(``include/config.h:26-71``, ``src/config.cpp:9-202``):

- a JSON config file is the source of truth;
- ``--key value`` command-line pairs override keys, with each value itself
  parsed as JSON and injected into the config tree
  (``src/config.cpp:24-28``);
- ``get(key)`` raises :class:`KeyNotFoundException` for missing keys, the
  two-argument form returns a default (``include/config.h:50-63``);
- ``get_path(key)`` resolves values relative to ``root_dir``
  (``src/config.cpp:58-60``);
- ``get_from_file(key)`` follows a file indirection: the value names another
  JSON file whose parsed content is returned (``include/config.h:40-48``);
- ``get_raw(key)`` returns nested JSON (used for the color codings).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple


class KeyNotFoundException(KeyError):
    """Raised when a required config key is missing (config.h:17-24)."""

    def __init__(self, key: str):
        super().__init__(key)
        self.key = key

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"Key not found in the config: {self.key}"


def parse_cli_overrides(argv: Iterable[str]) -> Dict[str, str]:
    """Parse ``--key value`` pairs into a dict.

    Mirrors ``Utils::parseParamters`` (``include/commandline_parser.h:9-33``):
    arguments must come in pairs, each key prefixed by ``--``. Returns the
    mapping; raises ``ValueError`` on mangled input (the reference returns
    false and the caller throws).
    """
    args = list(argv)
    if len(args) % 2 != 0:
        raise ValueError("Mangled command line arguments: expected --key value pairs")
    out: Dict[str, str] = {}
    for i in range(0, len(args), 2):
        key = args[i]
        if not key.startswith("--"):
            raise ValueError(f"Expected --key, got: {key}")
        out[key[2:]] = args[i + 1]
    return out


def _parse_json_value(text: str) -> Any:
    """Parse an override value as JSON; bare strings fall back to str.

    The reference feeds each override through the JSON reader
    (``src/config.cpp:24-28``); a bare word like ``material`` is not valid
    JSON, so we keep it as a plain string for usability.
    """
    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return text


class Config:
    """Typed view over a JSON config tree with CLI overrides."""

    def __init__(
        self,
        config_file: Optional[str] = None,
        overrides: Optional[Mapping[str, str]] = None,
        root_dir_key: str = "root_dir",
        data: Optional[Dict[str, Any]] = None,
    ):
        if data is not None:
            self._conf: Dict[str, Any] = dict(data)
        elif config_file is not None:
            with open(config_file, "r") as f:
                self._conf = json.load(f)
        else:
            self._conf = {}
        if overrides:
            for key, value in overrides.items():
                self._conf[key] = _parse_json_value(value)
        # Mirrors config.cpp:29 (root dir looked up eagerly) but tolerates
        # configs without one so pure-override configs work (config.cpp:32-41).
        self._root_dir = str(self._conf.get(root_dir_key, ""))

    _MISSING = object()

    def get(self, key: str, default: Any = _MISSING) -> Any:
        if key in self._conf:
            return self._conf[key]
        if default is not Config._MISSING:
            return default
        raise KeyNotFoundException(key)

    def get_bool(self, key: str, default: Any = _MISSING) -> bool:
        return bool(self.get(key, default))

    def get_int(self, key: str, default: Any = _MISSING) -> int:
        return int(self.get(key, default))

    def get_float(self, key: str, default: Any = _MISSING) -> float:
        return float(self.get(key, default))

    def get_str(self, key: str, default: Any = _MISSING) -> str:
        return str(self.get(key, default))

    def get_list(self, key: str, default: Any = _MISSING) -> List[Any]:
        return list(self.get(key, default))

    def get_raw(self, key: str) -> Any:
        """Nested JSON access (``src/config.cpp:66-68``)."""
        return self.get(key)

    @property
    def root_dir(self) -> str:
        return self._root_dir

    def get_path(self, key: str) -> str:
        """``root_dir + "/" + value`` (``src/config.cpp:58-60``)."""
        return os.path.join(self._root_dir, self.get_str(key))

    def get_from_file(self, key: str) -> Any:
        """Load the JSON file named by ``key`` (``include/config.h:40-48``).

        The file path is resolved relative to ``root_dir`` exactly like
        ``getPath``.
        """
        path = self.get_path(key)
        with open(path, "r") as f:
            return json.load(f)

    def set(self, key: str, value: Any) -> None:
        self._conf[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._conf

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._conf)


def load_config_from_argv(argv: List[str]) -> Tuple[Config, Dict[str, str]]:
    """CLI entry helper reproducing train/test argument handling.

    Mirrors ``src/train.cpp:41-54``: parse ``--key value`` pairs, require a
    ``--conf`` file, feed the remaining pairs as overrides.
    """
    params = parse_cli_overrides(argv)
    if "conf" not in params:
        raise ValueError("No config file was given (use --conf <config file>)")
    config_file = params.pop("conf")
    return Config(config_file, params), params
