"""Declarative configuration engine (port of the JAX package's
``core/config.py``; PyYAML is imported only where a YAML file is read).

Capability-parity with the reference's ConfigWizard
(``RetrievalAugmentedGeneration/common/configuration_wizard.py:99-310``):
frozen-dataclass config trees loadable from a JSON *or* YAML file (format
sniffed), with an environment-variable overlay and self-documenting help
output.  The implementation is new — plain stdlib dataclasses plus a small
recursive constructor; no dataclass-wizard dependency.

Environment mapping follows the reference convention
(``configuration_wizard.py:179-256``): a leaf at path ``app.vector_store.url``
maps to ``APP_VECTORSTORE_URL`` — each path segment has its underscores
removed and is upper-cased, segments joined by ``_`` under the ``APP`` prefix.
Environment values are JSON-parsed when possible so ``APP_RETRIEVER_TOPK=4``
arrives as an int and ``APP_LLM_MODELNAME=llama`` as a string.
"""

from __future__ import annotations

import dataclasses
import json
import os
import textwrap
import typing
from dataclasses import MISSING, dataclass, fields, is_dataclass
from typing import Any, Mapping, Optional, Type, TypeVar, Union, get_args, get_origin

_T = TypeVar("_T")

_HELP_KEY = "gaie_help"
_ENV_KEY = "gaie_env"

DEFAULT_ENV_PREFIX = "APP"


class ConfigError(ValueError):
    """Raised when a config tree cannot be constructed from its sources."""


def configfield(
    help_text: str = "",
    *,
    default: Any = MISSING,
    default_factory: Any = MISSING,
    env: Union[bool, str] = True,
) -> Any:
    """Declare one field of a config tree.

    Args:
      help_text: one-line description surfaced by :func:`format_help`.
      default: default value (immutable).
      default_factory: factory for mutable defaults.
      env: ``True`` to derive the env-var name from the field path, a string
        to pin an explicit env-var name, ``False`` to disable env overlay for
        this field.
    """
    kwargs: dict = {"metadata": {_HELP_KEY: help_text, _ENV_KEY: env}}
    if default is not MISSING:
        kwargs["default"] = default
    if default_factory is not MISSING:
        kwargs["default_factory"] = default_factory
    return dataclasses.field(**kwargs)


def configclass(cls: Optional[type] = None, /) -> Any:
    """Class decorator marking a node of a config tree (frozen dataclass)."""
    if cls is None:
        return configclass
    return dataclass(frozen=True)(cls)


def _env_segment(name: str) -> str:
    return name.replace("_", "").upper()


def env_name_for_path(path: tuple[str, ...], prefix: str = DEFAULT_ENV_PREFIX) -> str:
    """``("vector_store", "url") -> "APP_VECTORSTORE_URL"``."""
    return "_".join([prefix] + [_env_segment(p) for p in path])


def _parse_env_value(raw: str) -> Any:
    """JSON-parse when possible; fall back to the raw string."""
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        return raw


def _resolve_types(cls: type) -> dict[str, Any]:
    try:
        return typing.get_type_hints(cls)
    except Exception:  # pragma: no cover - unresolvable forward refs
        return {f.name: f.type for f in fields(cls)}


def _unwrap_optional(tp: Any) -> tuple[Any, bool]:
    if get_origin(tp) is Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _coerce(value: Any, tp: Any, path: tuple[str, ...]) -> Any:
    """Best-effort coercion of a parsed value into the annotated type."""
    tp, is_opt = _unwrap_optional(tp)
    if value is None:
        if is_opt:
            return None
        raise ConfigError(f"{'.'.join(path)}: null is not allowed")
    origin = get_origin(tp)
    if origin in (list, tuple):
        if isinstance(value, str):
            value = [v.strip() for v in value.split(",") if v.strip()]
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{'.'.join(path)}: expected a sequence, got {type(value).__name__}")
        args = get_args(tp)
        elem_tp = args[0] if args and args[0] is not Ellipsis else Any
        seq = [_coerce(v, elem_tp, path + (f"[{i}]",)) for i, v in enumerate(value)]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        if not isinstance(value, Mapping):
            raise ConfigError(f"{'.'.join(path)}: expected a mapping, got {type(value).__name__}")
        return dict(value)
    if tp is Any:
        return value
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.strip().lower()
            if low in ("true", "1", "yes", "on"):
                return True
            if low in ("false", "0", "no", "off"):
                return False
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        raise ConfigError(f"{'.'.join(path)}: cannot interpret {value!r} as bool")
    if tp is int:
        if isinstance(value, bool):
            raise ConfigError(f"{'.'.join(path)}: cannot interpret bool as int")
        try:
            return int(value)
        except (TypeError, ValueError):
            raise ConfigError(f"{'.'.join(path)}: cannot interpret {value!r} as int") from None
    if tp is float:
        try:
            return float(value)
        except (TypeError, ValueError):
            raise ConfigError(f"{'.'.join(path)}: cannot interpret {value!r} as float") from None
    if tp is str:
        if isinstance(value, (dict, list)):
            raise ConfigError(f"{'.'.join(path)}: expected a string, got {type(value).__name__}")
        return str(value)
    return value


def _field_env_name(f: dataclasses.Field, path: tuple[str, ...], prefix: str) -> Optional[str]:
    env = f.metadata.get(_ENV_KEY, True)
    if env is False:
        return None
    if isinstance(env, str):
        return env
    return env_name_for_path(path, prefix)


def _build(
    cls: Type[_T],
    data: Mapping[str, Any],
    path: tuple[str, ...],
    prefix: str,
    use_env: bool,
) -> _T:
    types = _resolve_types(cls)
    kwargs: dict[str, Any] = {}
    for f in fields(cls):
        ftype, _ = _unwrap_optional(types.get(f.name, f.type))
        fpath = path + (f.name,)
        if is_dataclass(ftype):
            sub = data.get(f.name, {})
            if not isinstance(sub, Mapping):
                raise ConfigError(f"{'.'.join(fpath)}: expected a mapping section")
            kwargs[f.name] = _build(ftype, sub, fpath, prefix, use_env)
            continue
        env_name = _field_env_name(f, fpath, prefix) if use_env else None
        if env_name is not None and env_name in os.environ:
            kwargs[f.name] = _coerce(_parse_env_value(os.environ[env_name]), types.get(f.name, f.type), fpath)
        elif f.name in data:
            kwargs[f.name] = _coerce(data[f.name], types.get(f.name, f.type), fpath)
        elif f.default is not MISSING or f.default_factory is not MISSING:  # type: ignore[misc]
            continue  # dataclass default applies
        else:
            raise ConfigError(f"{'.'.join(fpath)}: required field missing (set {env_name or 'it in the config file'})")
    return cls(**kwargs)


def _load_file(path: str) -> Mapping[str, Any]:
    """Read a config file, sniffing JSON vs YAML (reference: wizard :313-358)."""
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            pass
    try:
        import yaml
    except ImportError:
        raise ConfigError(
            f"{path}: reading a YAML config file needs PyYAML, which is not "
            "installed; use a JSON file or APP_* environment variables"
        ) from None
    data = yaml.safe_load(text)
    if data is None:
        return {}
    if not isinstance(data, Mapping):
        raise ConfigError(f"{path}: top level of a config file must be a mapping")
    return data


def load_config(
    cls: Type[_T],
    *,
    path: Optional[str] = None,
    data: Optional[Mapping[str, Any]] = None,
    env: bool = True,
    env_prefix: str = DEFAULT_ENV_PREFIX,
) -> _T:
    """Construct a config tree from (optional) file + (optional) env overlay.

    Precedence, highest first: environment variables, file/data values,
    dataclass defaults — mirroring the reference's merge order
    (``configuration_wizard.py:179-256``).
    """
    merged: Mapping[str, Any] = {}
    if path:
        merged = _load_file(path)
    if data:
        merged = _deep_merge(merged, data)
    return _build(cls, merged, (), env_prefix, env)


def _deep_merge(base: Mapping[str, Any], over: Mapping[str, Any]) -> dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def to_dict(cfg: Any) -> dict[str, Any]:
    """Config tree -> plain nested dict (for logging / serialization)."""
    return dataclasses.asdict(cfg)


def format_help(cls: type, *, env_prefix: str = DEFAULT_ENV_PREFIX) -> str:
    """Render the full annotated schema (``--help-config`` equivalent,
    reference ``configuration_wizard.py:104-177``)."""
    lines: list[str] = []

    def walk(c: type, path: tuple[str, ...], indent: int) -> None:
        types = _resolve_types(c)
        for f in fields(c):
            ftype, _ = _unwrap_optional(types.get(f.name, f.type))
            fpath = path + (f.name,)
            pad = "  " * indent
            if is_dataclass(ftype):
                lines.append(f"{pad}{f.name}:  # section")
                walk(ftype, fpath, indent + 1)
                continue
            help_txt = f.metadata.get(_HELP_KEY, "")
            env_name = _field_env_name(f, fpath, env_prefix)
            default: Any = None
            if f.default is not MISSING:
                default = f.default
            elif f.default_factory is not MISSING:  # type: ignore[misc]
                default = f.default_factory()
            tname = getattr(ftype, "__name__", str(ftype))
            lines.append(f"{pad}{f.name} ({tname}) = {default!r}")
            if help_txt:
                lines.append(textwrap.indent(textwrap.fill(help_txt, 72), pad + "    "))
            if env_name:
                lines.append(f"{pad}    env: {env_name}")
    walk(cls, (), 0)
    return "\n".join(lines)
