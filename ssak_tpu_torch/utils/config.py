"""YAML configuration for trainers and tools (counterpart of
ssak_tpu.utils.config): plain YAML + ${key} interpolation + dotted-path CLI
overrides, read by the port's own YAML reader (utils/yaml_reader: the card
host has no PyYAML), which types scalars as PyYAML's safe_load does.

    cfg = load_config("train.yaml", overrides=["optim.lr=3e-4"])

Interpolation: values may reference other keys with ${a.b.c}. A value that
is one whole reference keeps the referenced value's type; one that, once
substituted, holds only digits, signs, dots, e, E, parentheses and * / is
read again as a YAML scalar (so "${a} * 2" stays a string, as in ssak_tpu).
"""

import re

from ssak_tpu_torch.utils.yaml_reader import safe_load

_REF_RE = re.compile(r"\$\{([\w.]+)\}")


def _get_path(tree, dotted):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def _set_path(tree, dotted, value):
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _parse_scalar(text: str):
    return safe_load(text)


def _interpolate(tree):
    changed = True
    passes = 0
    while changed and passes < 10:
        changed = False
        passes += 1

        def walk(node):
            nonlocal changed
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v) for v in node]
            if isinstance(node, str) and "${" in node:
                def sub(m):
                    try:
                        val = _get_path(tree, m.group(1))
                    except (KeyError, TypeError):
                        return m.group(0)
                    return str(val)

                new = _REF_RE.sub(sub, node)
                if new != node:
                    changed = True
                    # full-value references keep their native type
                    m = _REF_RE.fullmatch(node)
                    if m:
                        try:
                            return _get_path(tree, m.group(1))
                        except (KeyError, TypeError):
                            return new
                    return _parse_scalar(new) if re.fullmatch(r"[-+*/.\d\s()eE]+", new) else new
                return node
            return node

        tree = walk(tree)
    return tree


def load_config(path: str = None, overrides=None, base: dict = None) -> dict:
    """Load YAML config (optional), apply 'a.b=value' overrides, resolve
    ${refs}. Returns a plain nested dict."""
    tree = dict(base or {})
    if path:
        with open(path, encoding="utf-8") as f:
            loaded = safe_load(f.read()) or {}
        tree.update(loaded)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, _eq, val = ov.partition("=")
        _set_path(tree, key.strip(), _parse_scalar(val.strip()))
    return _interpolate(tree)


def flatten_config(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_config(v, key))
        else:
            out[key] = v
    return out
