"""A Hydra-compatible configuration engine (counterpart of
`dpcr_agb_tpu/config/engine.py`), on the port's own YAML reader
(`config/yaml.py`): the GPU machine has no PyYAML.

It composes the `conf/` tree as the root CLIs do:

  * ``defaults`` lists: ``- group: option`` entries composed in order, and
    bare ``- path/to/config`` entries resolved against the current group.
  * ``# @package <path>`` headers: a file's content lands at <path> instead
    of the group path (``_global_`` included).
  * ``${a.b.c}`` interpolation, nested (``${models.${model_name}.x}``), and
    the ``${now:%fmt}`` and ``${env:NAME,default}`` resolvers.
  * ``???`` mandatory values, which raise when read.
  * The override grammar: ``group=option`` (select a defaults group),
    ``a.b.c=value`` (set a leaf), ``+a.b=value`` (add a key), ``~a.b``
    (delete a key).
"""
from __future__ import annotations

import copy
import datetime
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from . import yaml

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class MissingMandatoryValue(Exception):
    pass


class Cfg:
    """Attribute/str-key access wrapper over a plain dict tree with lazy
    ``${...}`` interpolation resolved against the root config."""

    __slots__ = ("_data", "_root")

    def __init__(self, data: Dict[str, Any], root: Optional["Cfg"] = None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_root", root if root is not None else self)

    # -- core access ---------------------------------------------------------
    def _wrap(self, key: str, value: Any) -> Any:
        if isinstance(value, str):
            value = _resolve_str(value, self._root_data())
            if value == MISSING:
                raise MissingMandatoryValue(f"Missing mandatory value: {key}")
        if isinstance(value, dict):
            return Cfg(value, self._root)
        return value

    def _root_data(self) -> Dict[str, Any]:
        return object.__getattribute__(self._root, "_data")

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        data = object.__getattribute__(self, "_data")
        if key not in data:
            raise AttributeError(f"Config key not found: {key}")
        return self._wrap(key, data[key])

    def __getitem__(self, key: str) -> Any:
        return getattr(self, str(key))

    def __setattr__(self, key: str, value: Any) -> None:
        if isinstance(value, Cfg):
            value = value.to_dict(resolve=False)
        self._data[key] = value

    __setitem__ = __setattr__

    def get(self, key: str, default: Any = None) -> Any:
        data = self._data
        if key not in data:
            return default
        try:
            v = self._wrap(key, data[key])
        except MissingMandatoryValue:
            return default
        return default if v is None else v

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        for k in self._data:
            yield k, self._wrap(k, self._data[k])

    def values(self):
        for k in self._data:
            yield self._wrap(k, self._data[k])

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __bool__(self) -> bool:
        return bool(self._data)

    def __eq__(self, other) -> bool:
        if isinstance(other, Cfg):
            return self._data == other._data
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def to_dict(self, resolve: bool = True) -> Dict[str, Any]:
        if not resolve:
            return copy.deepcopy(self._data)
        return _resolve_tree(copy.deepcopy(self._data), self._root_data())

    def select(self, dotted: str, default: Any = None) -> Any:
        """Fetch ``a.b.c`` path, returning default when any link is missing."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Cfg) or part not in node:
                return default
            try:
                node = node[part]
            except MissingMandatoryValue:
                return default
        return node

    def __repr__(self) -> str:
        return f"Cfg({self._data!r})"

    def pretty(self) -> str:
        return yaml.dump(self.to_dict(resolve=False))


# -- interpolation -----------------------------------------------------------

def _lookup(root: Dict[str, Any], dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"Interpolation key not found: {dotted}")
        node = node[part]
    if isinstance(node, str):
        node = _resolve_str(node, root)
    return node


def _resolve_str(value: str, root: Dict[str, Any], depth: int = 0) -> Any:
    if depth > 20:
        raise RecursionError(f"Interpolation cycle while resolving: {value!r}")
    m = _INTERP_RE.search(value)
    if m is None:
        return value
    # full-string single interpolation keeps the referenced value's type
    if m.span() == (0, len(value)):
        return _resolve_expr(m.group(1), root, depth)
    out, pos = [], 0
    while m is not None:
        out.append(value[pos:m.start()])
        out.append(str(_resolve_expr(m.group(1), root, depth)))
        pos = m.end()
        m = _INTERP_RE.search(value, pos)
    out.append(value[pos:])
    resolved = "".join(out)
    if _INTERP_RE.search(resolved):  # nested ${...${...}...}
        return _resolve_str(resolved, root, depth + 1)
    return resolved


def _resolve_expr(expr: str, root: Dict[str, Any], depth: int) -> Any:
    if ":" in expr:
        resolver, arg = expr.split(":", 1)
        if resolver == "now":
            return datetime.datetime.now().strftime(arg)
        if resolver == "env":
            name, _, dflt = arg.partition(",")
            return os.environ.get(name, dflt)
        raise KeyError(f"Unknown resolver: {resolver}")
    v = _lookup(root, expr)
    if isinstance(v, str):
        v = _resolve_str(v, root, depth + 1)
    return v


def _resolve_tree(node: Any, root: Dict[str, Any]) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_tree(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_tree(v, root) for v in node]
    if isinstance(node, str):
        v = _resolve_str(node, root)
        if isinstance(v, (dict, list)):
            return _resolve_tree(copy.deepcopy(v), root)
        return v
    return node


# -- composition -------------------------------------------------------------

def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _deep_merge(dst[k], v)
        elif v == MISSING and k in dst:
            # OmegaConf semantics: merging ??? over a concrete value keeps it
            continue
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _read_yaml(path: str) -> Tuple[Dict[str, Any], Optional[str]]:
    """Returns (content, package) where package comes from a '# @package x' header."""
    with open(path, "r") as f:
        text = f.read()
    package = None
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith("# @package"):
            package = stripped.split("# @package", 1)[1].strip()
            break
        if stripped and not stripped.startswith("#"):
            break
    content = yaml.safe_load(text)
    if content is None:
        content = {}
    if not isinstance(content, dict):
        raise ValueError(f"Top-level YAML must be a mapping: {path}")
    # YAML 1.1 reads "1e-2" (no dot/sign-exponent) as a string; OmegaConf
    # coerces — match that so the reference's config grammar works verbatim
    content = _coerce_numbers(content)
    # keys starting with "_" are file-local anchor scaffolding, not config
    content = {k: v for k, v in content.items() if not str(k).startswith("_")}
    return content, package


def _coerce_numbers(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _coerce_numbers(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_coerce_numbers(v) for v in node]
    if isinstance(node, str) and _FLOAT_RE.match(node):
        return float(node)
    return node


def _set_path(tree: Dict[str, Any], dotted: str, value: Dict[str, Any]) -> None:
    if dotted in ("", "_global_"):
        _deep_merge(tree, value)
        return
    node = tree
    parts = dotted.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    leaf = node.setdefault(parts[-1], {})
    if isinstance(leaf, dict):
        _deep_merge(leaf, value)
    else:
        node[parts[-1]] = copy.deepcopy(value)


def _compose_file(
    conf_dir: str,
    rel_path: str,
    tree: Dict[str, Any],
    group_overrides: Dict[str, str],
    default_package: Optional[str] = None,
) -> None:
    """Compose `conf_dir/rel_path.yaml` (with its defaults list) into `tree`."""
    path = os.path.join(conf_dir, rel_path + ".yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(f"Config file not found: {path}")
    content, package = _read_yaml(path)
    cur_group = os.path.dirname(rel_path)

    defaults = content.pop("defaults", None)
    if defaults:
        for entry in defaults:
            if entry == "_self_":
                continue
            if isinstance(entry, str):
                # bare path entry, relative to the current group directory
                sub_rel = os.path.join(cur_group, entry) if cur_group else entry
                # bare entries merge at the *current* package, like hydra
                _compose_file(conf_dir, sub_rel, tree, group_overrides,
                              default_package=package or default_package
                              or _group_package(cur_group))
                continue
            if isinstance(entry, dict):
                (group, option), = entry.items()
                if group in ("override", "optional"):
                    raise NotImplementedError(f"defaults entry {entry!r}")
                # a leading "/" means the group is absolute from the conf root
                group = group.lstrip("/")
                sel = group_overrides.get(group, option)
                if sel is None or sel == "null":
                    continue
                if sel == MISSING:
                    raise MissingMandatoryValue(
                        f"Mandatory defaults group '{group}' not selected; pass "
                        f"{group}=<option> on the command line")
                group_overrides.pop(group, None)
                _compose_file(conf_dir, os.path.join(group, str(sel)), tree,
                              group_overrides)
                continue
            raise ValueError(f"Unsupported defaults entry: {entry!r}")

    pkg = package if package is not None else (
        default_package if default_package is not None else _group_package(cur_group))
    _set_path(tree, pkg, content)


def _group_package(group: str) -> str:
    # hydra default: config in conf/<group>/x.yaml lands under key path <group>
    return group.replace(os.sep, ".").replace("/", ".")


_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _parse_value(text: str) -> Any:
    # YAML 1.1 rejects bare scientific notation like 1e-2; hydra accepts it
    if _FLOAT_RE.match(text.strip()):
        return float(text)
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def parse_overrides(overrides: List[str]) -> Tuple[Dict[str, str], List[Tuple[str, str, Any]]]:
    """Split CLI args into defaults-group selections and key-value edits.

    A ``x=y`` override is treated as a group selection when x has no dots; the
    composer consumes it if a matching defaults group exists, otherwise it falls
    through to a plain key set (matching hydra's behavior closely enough for the
    reference CLI grammar, where group names — task/data/models/training/
    lr_scheduler/visualization/debugging — never collide with leaf keys).
    """
    groups: Dict[str, str] = {}
    edits: List[Tuple[str, str, Any]] = []
    for ov in overrides:
        if ov.startswith("~"):
            edits.append(("del", ov[1:], None))
            continue
        mode = "set"
        if ov.startswith("++"):
            ov = ov[2:]
        elif ov.startswith("+"):
            mode = "add"
            ov = ov[1:]
        if "=" not in ov:
            raise ValueError(f"Override must be key=value or ~key: {ov!r}")
        key, val = ov.split("=", 1)
        key = key.strip()
        if "." not in key and mode == "set" and not key.startswith("_"):
            groups[key] = val.strip()
        else:
            edits.append((mode, key, _parse_value(val)))
    return groups, edits


def _apply_edit(tree: Dict[str, Any], mode: str, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            node[p] = nxt
        node = nxt
    if mode == "del":
        node.pop(parts[-1], None)
    else:
        node[parts[-1]] = value


def compose_from_checkpoint(overrides: List[str]) -> Optional[Cfg]:
    """Checkpoint-only composition (reference ModelCheckpoint.create_model,
    model_checkpoint.py:182-193): when the CLI gives `checkpoint_dir=` and
    `model_name=` but no `data=`/`task=` selections, rebuild the run config
    stored inside the checkpoint and apply the remaining overrides on top.
    Returns None when the overrides don't qualify (caller falls back to the
    normal conf-tree composition)."""
    if any(o.startswith(("data=", "task=")) for o in overrides):
        return None
    ckpt_dir = next((o.split("=", 1)[1] for o in overrides
                     if o.startswith("checkpoint_dir=")), None)
    name = next((o.split("=", 1)[1] for o in overrides
                 if o.startswith("model_name=")), None)
    if not (ckpt_dir and name):
        return None
    from ..training.state import Checkpoint
    path = os.path.join(ckpt_dir, f"{name}.ckpt")
    with open(path, "rb") as f:
        saved = Checkpoint.from_bytes(f.read()).run_config
    cfg = Cfg({**saved})
    groups, edits = parse_overrides(overrides)
    for key, val in groups.items():
        _apply_edit(cfg._data, "set", key, _parse_value(val))
    for mode, key, val in edits:
        _apply_edit(cfg._data, mode, key, val)
    return cfg


def load_config(conf_dir: str, root: str = "config",
                overrides: Optional[List[str]] = None) -> Cfg:
    """Compose `conf_dir/<root>.yaml` with Hydra-style defaults + CLI overrides."""
    overrides = list(overrides or [])
    groups, edits = parse_overrides(overrides)
    tree: Dict[str, Any] = {}
    _compose_file(conf_dir, root, tree, groups, default_package="_global_")
    # group selections that no defaults entry consumed are plain key sets
    for key, val in groups.items():
        _apply_edit(tree, "set", key, _parse_value(val))
    for mode, key, val in edits:
        _apply_edit(tree, mode, key, val)
    return Cfg(tree)
