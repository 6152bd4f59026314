"""YAML app loader: the port's own copy of
``pathway_tpu/internals/yaml_loader.py`` (reference:
python/pathway/internals/yaml_loader.py, ``pw.load_yaml``): declarative app
assembly — ``$ref``-style class instantiation with ``!pw.module.Class`` tags
expressed as ``$class`` mappings. ``yaml`` is imported inside
``load_yaml``; without it the call raises ``ImportError``, as in the JAX
package. Nothing is left out."""

from __future__ import annotations

import importlib
from typing import Any, IO


def _instantiate(obj: Any, definitions: dict[str, Any]) -> Any:
    if isinstance(obj, dict):
        if "$ref" in obj:
            name = obj["$ref"]
            if name not in definitions:
                raise ValueError(f"unresolved $ref: {name}")
            return definitions[name]
        if "$class" in obj:
            path = obj["$class"]
            module_name, _, cls_name = path.rpartition(".")
            cls = getattr(importlib.import_module(module_name), cls_name)
            kwargs = {
                k: _instantiate(v, definitions)
                for k, v in obj.items()
                if k != "$class"
            }
            return cls(**kwargs)
        return {k: _instantiate(v, definitions) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_instantiate(v, definitions) for v in obj]
    return obj


def load_yaml(stream: str | IO) -> Any:
    try:
        import yaml
    except ImportError as exc:  # pragma: no cover
        raise ImportError("pyyaml is required for pw.load_yaml") from exc
    if hasattr(stream, "read"):
        data = yaml.safe_load(stream)
    else:
        import os

        if isinstance(stream, str) and os.path.exists(stream):
            with open(stream) as f:
                data = yaml.safe_load(f)
        else:
            data = yaml.safe_load(stream)
    if not isinstance(data, dict):
        return data
    definitions: dict[str, Any] = {}
    out: dict[str, Any] = {}
    for key, val in data.items():
        inst = _instantiate(val, definitions)
        definitions[key] = inst
        out[key] = inst
    return out
