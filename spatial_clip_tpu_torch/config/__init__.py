"""Hydra-style YAML config composition (counterpart of ``spatial_clip_tpu.config``).

The same subset of Hydra 1.3 as the JAX package's module, over the same
``configs/`` tree, read in place:

- a root config with a ``defaults:`` list of ``{group: name}`` entries and
  ``_self_`` ordering,
- group YAML files under ``configs/<group>/<name>.yaml``, placed under their
  group key unless they start with ``# @package _global_``,
- CLI overrides: ``group=name`` (swap a group), ``a.b.c=value`` (set, YAML-
  parsed), ``+a.b=value`` (add), ``~a.b`` (delete), ``experiment=foo``,
- ``${a.b.c}`` interpolation after merging,
- ``instantiate()`` for ``_target_`` nodes incl. ``_partial_: true``.

The configs name the JAX package's classes (``_target_:
spatial_clip_tpu.data.datamodule.SpatialClipDataModule``). :func:`instantiate`
builds the class at the same dotted path under ``spatial_clip_tpu_torch.``
and refuses, naming it, a target this package lacks; it never imports the
JAX package.
"""
from __future__ import annotations

import functools
import importlib
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import yaml

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")
_PACKAGE_RE = re.compile(r"^#\s*@package\s+(\S+)")


# ----------------------------------------------------------------- primitives
def load_yaml(path: Union[str, Path]) -> tuple:
    """Load a YAML file; returns (content_dict, package_directive_or_None)."""
    text = Path(path).read_text()
    m = _PACKAGE_RE.match(text.strip().splitlines()[0]) if text.strip() else None
    package = m.group(1) if m else None
    data = yaml.safe_load(text)
    return (data or {}), package


def deep_merge(base: Dict, overlay: Dict) -> Dict:
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def get_path(cfg: Dict, dotted: str, default=None):
    node: Any = cfg
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def set_path(cfg: Dict, dotted: str, value: Any):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def del_path(cfg: Dict, dotted: str):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.get(p, {})
        if not isinstance(node, dict):
            return
    node.pop(parts[-1], None)


def _parse_value(text: str) -> Any:
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


# -------------------------------------------------------------- interpolation
def resolve_interpolations(cfg: Dict) -> Dict:
    def resolve(node: Any, seen: tuple) -> Any:
        if isinstance(node, dict):
            return {k: resolve(v, seen) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v, seen) for v in node]
        if isinstance(node, str):
            m = _INTERP_RE.fullmatch(node)
            if m:  # whole-value interpolation keeps the referent's type
                key = m.group(1)
                if key in seen:
                    raise ValueError(f"interpolation cycle at ${{{key}}}")
                return resolve(get_path(cfg, key), seen + (key,))

            def sub(mm):
                key = mm.group(1)
                val = resolve(get_path(cfg, key), seen + (key,))
                return str(val)

            return _INTERP_RE.sub(sub, node)
        return node

    return resolve(cfg, ())


# ------------------------------------------------------------------- compose
def compose(
    config_dir: Union[str, Path],
    config_name: str = "train",
    overrides: Optional[Sequence[str]] = None,
) -> Dict:
    """Compose ``<config_dir>/<config_name>.yaml`` with its defaults list and
    CLI-style overrides: the group composition of ``configs/train.yaml``
    with the experiment/debug overlays."""
    config_dir = Path(config_dir)
    overrides = list(overrides or [])

    root, _ = load_yaml(config_dir / f"{config_name}.yaml")
    defaults: List[Any] = root.pop("defaults", [])

    # group swaps from overrides apply to the defaults list
    group_choices: Dict[str, Optional[str]] = {}
    value_overrides: List[str] = []
    for ov in overrides:
        if ov.startswith("~"):
            value_overrides.append(ov)
            continue
        if "=" not in ov:
            raise ValueError(f"bad override '{ov}' (need key=value)")
        key, val = ov.split("=", 1)
        plain_key = key.lstrip("+")
        if (
            "." not in plain_key
            and (config_dir / plain_key).is_dir()
        ):
            group_choices[plain_key] = None if val in ("null", "None") else val
        else:
            value_overrides.append(ov)

    cfg: Dict = {}
    self_merged = False
    seen_groups = []
    for entry in defaults:
        if entry == "_self_":
            cfg = deep_merge(cfg, root)
            self_merged = True
            continue
        optional = False
        if isinstance(entry, str) and entry.startswith("optional "):
            # bare string form "optional group: name" parses as str
            entry_str = entry[len("optional "):]
            group, _, name = entry_str.partition(":")
            entry = {group.strip(): name.strip() or None}
            optional = True
        if not isinstance(entry, dict):
            raise ValueError(f"bad defaults entry: {entry!r}")
        (group, name), = entry.items()
        if isinstance(group, str) and group.startswith("optional "):
            group = group[len("optional "):]
            optional = True
        seen_groups.append(group)
        name = group_choices.pop(group, name)
        if name is None:
            continue
        path = config_dir / group / f"{name}.yaml"
        if not path.exists():
            if optional:
                continue
            raise FileNotFoundError(f"config group file not found: {path}")
        content, package = load_yaml(path)
        content = _apply_group_defaults(config_dir, group, content)
        if package == "_global_":
            cfg = deep_merge(cfg, content)
        else:
            cfg = deep_merge(cfg, {group: content})
    # group overrides naming groups absent from the defaults list
    for group, name in group_choices.items():
        if name is None:
            continue
        content, package = load_yaml(config_dir / group / f"{name}.yaml")
        content = _apply_group_defaults(config_dir, group, content)
        if package == "_global_":
            cfg = deep_merge(cfg, content)
        else:
            cfg = deep_merge(cfg, {group: content})
    if not self_merged:
        cfg = deep_merge(cfg, root)

    for ov in value_overrides:
        if ov.startswith("~"):
            del_path(cfg, ov[1:])
            continue
        key, val = ov.split("=", 1)
        set_path(cfg, key.lstrip("+"), _parse_value(val))

    return resolve_interpolations(cfg)


def _apply_group_defaults(config_dir: Path, group: str, content: Dict) -> Dict:
    """Group files may themselves carry a defaults list (same-group only)."""
    subdefaults = content.pop("defaults", None)
    if not subdefaults:
        return content
    merged: Dict = {}
    for entry in subdefaults:
        if entry == "_self_":
            merged = deep_merge(merged, content)
            continue
        (g, name), = entry.items() if isinstance(entry, dict) else ((group, entry),)
        sub, _ = load_yaml(config_dir / g / f"{name}.yaml")
        merged = deep_merge(merged, sub)
    if content and "_self_" not in (subdefaults or []):
        merged = deep_merge(merged, content)
    return merged


# ---------------------------------------------------------------- instantiate
JAX_PACKAGE, PACKAGE = "spatial_clip_tpu", "spatial_clip_tpu_torch"


def port_target(dotted: str) -> str:
    """The dotted path under this package of a target under the JAX
    package's; any other target is returned as it is."""
    root, dot, rest = dotted.partition(".")
    return f"{PACKAGE}{dot}{rest}" if root == JAX_PACKAGE else dotted


def _import_target(dotted: str):
    target = port_target(dotted)
    module, _, attr = target.rpartition(".")
    try:
        found = getattr(importlib.import_module(module), attr, None)
    except ModuleNotFoundError as e:
        if not (target.startswith(PACKAGE + ".") and e.name and module.startswith(e.name)):
            raise  # a dependency of the module is missing, not the module
        found = None
    if found is None and target.startswith(PACKAGE + "."):
        raise NotImplementedError(f"_target_ {dotted!r}: {target!r} is not ported to {PACKAGE}")
    if found is None:
        raise AttributeError(f"module {module!r} has no attribute {attr!r}")
    return found


def instantiate(node: Any, **kwargs):
    """Build objects from ``_target_`` nodes, recursively; a target under
    the JAX package is built from this package (:func:`port_target`)."""
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    if not isinstance(node, dict):
        return node
    node = dict(node)
    target = node.pop("_target_", None)
    partial = bool(node.pop("_partial_", False))
    built = {
        k: instantiate(v) if _needs_build(v) else v for k, v in node.items()
    }
    built.update(kwargs)
    if target is None:
        return built
    fn = _import_target(target)
    if partial:
        return functools.partial(fn, **built)
    return fn(**built)


def _needs_build(v) -> bool:
    if isinstance(v, dict):
        return True
    if isinstance(v, list):
        return any(_needs_build(x) for x in v)
    return False
