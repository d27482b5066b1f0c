"""Minimal hydra-like YAML config composition (a copy of
``vipe_tpu/utils/config.py``; PyYAML is imported only when a config is
read or an override parsed).

  * a root YAML with a ``defaults:`` list pulling group files
    (``configs/<group>/<name>.yaml``) into keys;
  * dotted CLI overrides (``slam.warmup=4``, ``pipeline=default``);
  * ``${a.b}`` interpolation plus the ``eq``/``neq`` resolvers used by
    ``configs/pipeline/default.yaml`` for ``optimize_intrinsics``.
"""

from __future__ import annotations

import copy
import pathlib
import re
from typing import Any, Optional

_INTERP = re.compile(r"^\$\{([^}]*)\}$")


def _get(cfg: dict, dotted: str):
    cur: Any = cfg
    for part in dotted.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            raise KeyError(dotted)
    return cur


def _set(cfg: dict, dotted: str, value):
    parts = dotted.split(".")
    cur = cfg
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def _parse_value(text: str):
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _split_args(body: str):
    """Split resolver args on top-level commas (no nested-brace splitting)."""
    out, depth, cur = [], 0, ""
    for ch in body:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    out.append(cur)
    return out


def _extract_interp(text: str):
    """Find ``${...}`` spans with balanced nested braces.

    Returns list of (start, end, inner) tuples.
    """
    spans = []
    i = 0
    while i < len(text):
        j = text.find("${", i)
        if j < 0:
            break
        depth = 0
        k = j + 2
        while k < len(text):
            if text.startswith("${", k):
                depth += 1
                k += 2
                continue
            if text[k] == "}":
                if depth == 0:
                    spans.append((j, k + 1, text[j + 2: k]))
                    break
                depth -= 1
            k += 1
        i = spans[-1][1] if spans and spans[-1][0] == j else j + 2
    return spans


def _resolve_node(value, root, path=()):
    if isinstance(value, dict):
        return {k: _resolve_node(v, root, path + (k,)) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_node(v, root, path) for v in value]
    if isinstance(value, str):
        spans = _extract_interp(value)
        if len(spans) == 1 and spans[0][0] == 0 and spans[0][1] == len(value):
            return _resolve_expr(spans[0][2], root, path)
        if spans:
            out, last = "", 0
            for (a, b, inner) in spans:
                out += value[last:a] + str(_resolve_expr(inner, root, path))
                last = b
            return out + value[last:]
    return value


def _resolve_expr(expr: str, root, path=()):
    expr = expr.strip()
    if ":" in expr and expr.split(":", 1)[0] in ("eq", "neq"):
        op, body = expr.split(":", 1)
        args = []
        for a in _split_args(body):
            a = a.strip()
            v = _resolve_node(a, root, path)
            if isinstance(v, str):
                v = _parse_value(v)
            args.append(v)
        assert len(args) == 2, f"resolver {op} needs 2 args: {expr}"
        return (args[0] == args[1]) if op == "eq" else (args[0] != args[1])
    # relative references (OmegaConf semantics): the value at ``path`` lives in
    # container path[:-1]; one dot = that container, each extra dot = one more
    # parent up
    target = expr
    if expr.startswith("."):
        n = len(expr) - len(expr.lstrip("."))
        base = path[: max(len(path) - n, 0)]
        rest = expr.lstrip(".")
        target = ".".join(base + tuple(rest.split("."))) if rest else ".".join(base)
    try:
        return _resolve_node(_get(root, target), root, path)
    except KeyError:
        return None


def _load_yaml(path: pathlib.Path) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def compose(
    config_dir,
    name: str = "default",
    overrides: Optional[list] = None,
) -> dict:
    """Compose ``<config_dir>/<name>.yaml`` + defaults-list + overrides."""
    config_dir = pathlib.Path(config_dir)
    root = _load_yaml(config_dir / f"{name}.yaml")
    defaults = root.pop("defaults", [])
    overrides = list(overrides or [])

    # group overrides like "pipeline=no_vda" swap the defaults entry
    group_over = {}
    kv_over = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if "." not in key and (config_dir / key / f"{val}.yaml").exists():
            group_over[key] = val
        else:
            kv_over.append((key, _parse_value(val)))

    cfg: dict = {}
    for entry in defaults:
        if entry == "_self_":
            _deep_merge(cfg, root)
            continue
        if isinstance(entry, str):
            group, gname = entry, "default"
        else:
            (group, gname), = entry.items()
        gname = group_over.get(group, gname)
        sub = _load_yaml(config_dir / group / f"{gname}.yaml")
        _deep_merge(cfg, {group: sub})
    if "_self_" not in defaults:
        _deep_merge(cfg, root)

    for key, val in kv_over:
        _set(cfg, key, val)

    return _resolve_node(cfg, cfg)


def _deep_merge(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def get_config_path() -> pathlib.Path:
    """The port's own config tree (``vipe_tpu_torch/configs``)."""
    return pathlib.Path(__file__).resolve().parents[1] / "configs"
