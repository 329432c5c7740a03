"""Dependency-free JSON-schema validation for BENCH_*.json artifacts.

The perf-trajectory artifacts (``BENCH_operator_sweep.json``,
``BENCH_serving.json``) are schema-versioned: their schemas are checked
into ``benchmarks/schemas/``.  This validator implements the subset of JSON Schema those
schemas use — ``type``, ``properties``, ``required``, ``items``,
``enum``, ``const``, ``minimum``, ``exclusiveMinimum``, ``minItems``,
``additionalProperties`` — so validation needs no third-party package
(the container may not ship ``jsonschema``; nothing may be installed).

Errors carry JSON-pointer-ish paths (``rows[3].dofs_per_s``) so a
schema-drift failure names the exact offending field.
"""

from __future__ import annotations

import json
import math
from typing import Any

__all__ = ["SchemaError", "validate_json", "validation_errors", "load_and_validate"]

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "null": type(None),
}


class SchemaError(ValueError):
    """Raised by :func:`validate_json`; ``errors`` lists every finding."""

    def __init__(self, errors: list[str]):
        self.errors = errors
        super().__init__(
            f"{len(errors)} schema violation(s):\n  " + "\n  ".join(errors)
        )


def _type_ok(value: Any, t: str) -> bool:
    if t == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if t == "integer":
        return (
            isinstance(value, int) and not isinstance(value, bool)
        ) or (isinstance(value, float) and float(value).is_integer())
    cls = _TYPES.get(t)
    if cls is None:
        raise ValueError(f"unsupported schema type {t!r}")
    ok = isinstance(value, cls)
    # bool is an int subclass in Python; don't let it pass as plain int.
    if ok and cls is not bool and isinstance(value, bool) and t != "boolean":
        return False
    return ok


def _walk(value: Any, schema: dict, path: str, errors: list[str]) -> None:
    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        if not any(_type_ok(value, x) for x in types):
            errors.append(
                f"{path or '$'}: expected type {'/'.join(types)}, got "
                f"{type(value).__name__} ({value!r:.80})"
            )
            return
    if "const" in schema and value != schema["const"]:
        errors.append(
            f"{path or '$'}: expected const {schema['const']!r}, got {value!r}"
        )
    if "enum" in schema and value not in schema["enum"]:
        errors.append(
            f"{path or '$'}: {value!r} not in enum {schema['enum']!r}"
        )
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            errors.append(
                f"{path or '$'}: {value!r} < minimum {schema['minimum']!r}"
            )
        if "exclusiveMinimum" in schema and value <= schema["exclusiveMinimum"]:
            errors.append(
                f"{path or '$'}: {value!r} <= exclusiveMinimum "
                f"{schema['exclusiveMinimum']!r}"
            )
        if (
            isinstance(value, float)
            and math.isnan(value)
            and not schema.get("allowNaN", False)
        ):
            errors.append(f"{path or '$'}: NaN is not a valid value")
    if isinstance(value, dict):
        props = schema.get("properties", {})
        for name in schema.get("required", []):
            if name not in value:
                errors.append(f"{path or '$'}: missing required key {name!r}")
        for name, sub in props.items():
            if name in value:
                _walk(value[name], sub, f"{path}.{name}" if path else name,
                      errors)
        ap = schema.get("additionalProperties", True)
        if ap is False:
            for name in value:
                if name not in props:
                    errors.append(
                        f"{path or '$'}: unexpected key {name!r} "
                        f"(additionalProperties: false)"
                    )
        elif isinstance(ap, dict):
            for name, v in value.items():
                if name not in props:
                    _walk(v, ap, f"{path}.{name}" if path else name, errors)
    if isinstance(value, list):
        if "minItems" in schema and len(value) < schema["minItems"]:
            errors.append(
                f"{path or '$'}: {len(value)} item(s) < minItems "
                f"{schema['minItems']}"
            )
        items = schema.get("items")
        if isinstance(items, dict):
            for i, v in enumerate(value):
                _walk(v, items, f"{path}[{i}]", errors)


def validation_errors(instance: Any, schema: dict) -> list[str]:
    """Every violation of ``schema`` by ``instance`` (empty = valid)."""
    errors: list[str] = []
    _walk(instance, schema, "", errors)
    return errors


def validate_json(instance: Any, schema: dict) -> None:
    """Raise :class:`SchemaError` listing every violation; no-op when
    ``instance`` conforms."""
    errors = validation_errors(instance, schema)
    if errors:
        raise SchemaError(errors)


def load_and_validate(artifact_path: str, schema_path: str) -> dict:
    """Read a JSON artifact, validate it, and return the parsed doc."""
    with open(artifact_path) as f:
        doc = json.load(f)
    with open(schema_path) as f:
        schema = json.load(f)
    validate_json(doc, schema)
    return doc
