"""Config-parameter schema validation and nested-dict helpers (the
port's copy of ``openseq2seq_tpu/utils/params.py``).

Re-implements the contract of the reference's parameter machinery
(`open_seq2seq/utils/utils.py:403-429` check_params and
`utils/utils.py:326-363` flatten/nest/nested_update): every component
declares required/optional parameter schemas; unknown keys are hard
errors; schema values may be a type, a list of allowed values, or
``None`` (anything goes).
"""
from __future__ import annotations

from typing import Any, Dict


def check_params(config: Dict[str, Any],
                 required_dict: Dict[str, Any],
                 optional_dict: Dict[str, Any]) -> None:
    """Validate ``config`` against required/optional schemas.

    Schema values are interpreted as:
      * ``None`` — any value accepted;
      * a ``type`` (e.g. ``int``) — value must be an instance (bools are
        not accepted for int/float slots unless the schema says bool);
      * a ``list`` — value must be one of the listed options.

    Raises ``ValueError`` on a missing required key, a wrong type/option,
    or an unknown key.
    """
    if required_dict is None:
        required_dict = {}
    if optional_dict is None:
        optional_dict = {}

    def _check_one(key, spec, value):
        if spec is None:
            return
        if isinstance(spec, list):
            if value not in spec:
                raise ValueError(
                    "Config parameter '{}' has to be one of {}, got {!r}"
                    .format(key, spec, value))
            return
        if isinstance(spec, type):
            ok = isinstance(value, spec)
            # bool is a subclass of int in Python; don't let a bool
            # satisfy an int/float schema slot.
            if spec in (int, float) and isinstance(value, bool):
                ok = False
            # an int is fine where a float is expected
            if spec is float and isinstance(value, int) and not isinstance(value, bool):
                ok = True
            if not ok:
                raise ValueError(
                    "Config parameter '{}' has to be of type {}, got {!r}"
                    .format(key, spec.__name__, type(value).__name__))
            return
        # spec is a concrete value: require equality
        if value != spec:
            raise ValueError(
                "Config parameter '{}' has to be equal to {!r}, got {!r}"
                .format(key, spec, value))

    for key, spec in required_dict.items():
        if key not in config:
            raise ValueError("Config parameter '{}' is required".format(key))
        _check_one(key, spec, config[key])

    for key, value in config.items():
        if key in required_dict:
            continue
        if key not in optional_dict:
            raise ValueError("Unknown config parameter '{}'".format(key))
        _check_one(key, optional_dict[key], value)


def flatten_dict(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Flatten nested dicts into ``{"a/b/c": leaf}`` (reference CLI-flag
    convention: every scalar leaf addressable as ``--a/b/c``)."""
    flat: Dict[str, Any] = {}
    for key, value in d.items():
        path = "{}/{}".format(prefix, key) if prefix else key
        if isinstance(value, dict):
            flat.update(flatten_dict(value, path))
        elif isinstance(value, (int, float, str, bool)):
            flat[path] = value
    return flat


def nest_dict(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_dict`."""
    nested: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = nested
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return nested


def nested_update(base: Dict[str, Any], update: Dict[str, Any]) -> None:
    """Recursively merge ``update`` into ``base`` in place (per-mode
    config dicts override ``base_params`` leaf-wise)."""
    for key, value in update.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            nested_update(base[key], value)
        else:
            base[key] = value
