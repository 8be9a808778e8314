"""A JSON Schema validator for ``response_format: json_schema``.

The JAX server checks a request's schema with the third-party
``jsonschema`` (``check_schema`` before any generation, ``validate`` on
the answer). The port keeps its own validator for the subset of JSON
Schema it serves:

- ``type``: ``object``, ``array``, ``string``, ``number``, ``integer``,
  ``boolean``, ``null``, or a list of them;
- ``properties`` and ``required`` (objects), ``items`` (a schema for
  every element of an array), ``enum``;
- ``true`` and ``false`` as schemas;
- the annotations ``title``, ``description``, ``$schema``, ``$id``,
  ``$comment``, ``examples`` and ``default``, which never change whether
  an instance is valid.

A schema that uses any other keyword is refused by :func:`check_schema`
with the keyword named: it is never accepted and then left unchecked.
Within the subset the verdicts are ``jsonschema``'s (draft 2020-12, the
default of ``validator_for`` for a schema without ``$schema``): an
``integer`` is an int or an integral float, never a bool; ``enum``
compares as JSON does, so ``1`` equals ``1.0`` and ``true`` equals
neither.
"""

from __future__ import annotations

from typing import Any, Optional

TYPES = ("object", "array", "string", "number", "integer", "boolean", "null")
KEYWORDS = ("type", "properties", "required", "items", "enum")
ANNOTATIONS = ("title", "description", "$schema", "$id", "$comment",
               "examples", "default")


class SchemaError(ValueError):
    """The schema itself is invalid or outside the served subset."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class ValidationError(ValueError):
    """An instance does not conform to a schema."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


def check_schema(schema: Any, path: str = "schema") -> None:
    """Raise :class:`SchemaError` unless ``schema`` is a valid schema of
    the served subset."""
    if isinstance(schema, bool):
        return
    if not isinstance(schema, dict):
        raise SchemaError(f"{path} must be an object or a boolean")
    for key in schema:
        if key not in KEYWORDS and key not in ANNOTATIONS:
            raise SchemaError(
                f"keyword {key!r} at {path} is not supported (this server "
                f"validates {', '.join(KEYWORDS)})"
            )
    if "type" in schema:
        t = schema["type"]
        names = t if isinstance(t, list) else [t]
        if isinstance(t, list) and (
            not t or len({str(n) for n in t}) != len(t)
        ):
            raise SchemaError(
                f"{t!r} at {path}.type is not a non-empty list of unique "
                "types"
            )
        for name in names:
            if name not in TYPES:
                raise SchemaError(f"{name!r} is not valid under any of the "
                                  f"given schemas ({path}.type)")
    if "properties" in schema:
        props = schema["properties"]
        if not isinstance(props, dict):
            raise SchemaError(f"{path}.properties must be an object")
        for name, sub in props.items():
            check_schema(sub, f"{path}.properties.{name}")
    if "required" in schema:
        req = schema["required"]
        if not isinstance(req, list) or not all(
            isinstance(r, str) for r in req
        ) or len(set(req)) != len(req):
            raise SchemaError(
                f"{path}.required must be a list of unique strings"
            )
    if "items" in schema:
        check_schema(schema["items"], f"{path}.items")
    if "enum" in schema and not isinstance(schema["enum"], list):
        raise SchemaError(f"{path}.enum must be an array")


def _is_type(instance: Any, name: str) -> bool:
    if name == "null":
        return instance is None
    if name == "boolean":
        return isinstance(instance, bool)
    if isinstance(instance, bool):
        return False
    if name == "integer":
        if isinstance(instance, float):
            return instance.is_integer()
        return isinstance(instance, int)
    if name == "number":
        return isinstance(instance, (int, float))
    if name == "string":
        return isinstance(instance, str)
    if name == "array":
        return isinstance(instance, list)
    return isinstance(instance, dict)


def _equal(a: Any, b: Any) -> bool:
    """JSON equality: a bool equals only a bool, numbers compare by
    value, arrays and objects element by element."""
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, dict)) or isinstance(b, (list, dict)):
        return False
    return a == b


def _first_error(instance: Any, schema: Any) -> Optional[str]:
    if schema is True:
        return None
    if schema is False:
        return f"False schema does not allow {instance!r}"
    if "type" in schema:
        t = schema["type"]
        names = t if isinstance(t, list) else [t]
        if not any(_is_type(instance, n) for n in names):
            return f"{instance!r} is not of type {', '.join(map(repr, names))}"
    if "enum" in schema and not any(
        _equal(instance, e) for e in schema["enum"]
    ):
        return f"{instance!r} is not one of {schema['enum']!r}"
    if isinstance(instance, dict):
        for name in schema.get("required", ()):
            if name not in instance:
                return f"{name!r} is a required property"
        for name, sub in schema.get("properties", {}).items():
            if name in instance:
                err = _first_error(instance[name], sub)
                if err:
                    return err
    if isinstance(instance, list) and "items" in schema:
        for item in instance:
            err = _first_error(item, schema["items"])
            if err:
                return err
    return None


def validate(instance: Any, schema: Any) -> None:
    """Raise :class:`ValidationError` with the first violation found, for
    a schema :func:`check_schema` accepted."""
    err = _first_error(instance, schema)
    if err:
        raise ValidationError(err)
