"""JSON-Schema validation for the keywords the groves' schemas use.

The port's own module: it has no counterpart in the JAX package, whose
grove validates ``file_write`` payloads with the ``jsonschema`` package.
The machine that serves the port on the GPU has no ``jsonschema``, so
the port always validates here.

``validate(instance, schema)`` raises :class:`ValidationError` whose
``message`` equals the one ``jsonschema.validate`` (Draft 2020-12, the
default for a schema without ``$schema``) gives for the same pair: the
errors come in the same order (the schema's keys in order, each
property's subschema where ``properties`` stands) and the one raised is
picked by the same relevance key as ``jsonschema.exceptions.best_match``.
The grove puts that message in the refused action's result.

Keywords: ``type`` (a name or a list of names), ``required``,
``properties``, ``pattern`` and ``minLength``, the ones the shipped
groves' schemas and the grove tests use. Any other keyword raises
:class:`SchemaError`: it is never skipped.
"""

from __future__ import annotations

import re
from typing import Any, Iterator


class SchemaError(ValueError):
    """A schema this module cannot check (an unknown keyword or a bad
    keyword value)."""


class ValidationError(ValueError):
    def __init__(self, message: str, *, path: tuple, instance: Any,
                 schema: dict):
        super().__init__(message)
        self.message = message
        self.path = path
        self.instance = instance
        self.schema = schema


_TYPES = ("array", "boolean", "integer", "null", "number", "object",
          "string")


def _is_type(instance: Any, name: str) -> bool:
    if name == "array":
        return isinstance(instance, list)
    if name == "boolean":
        return isinstance(instance, bool)
    if name == "integer":
        if isinstance(instance, bool):
            return False
        return isinstance(instance, int) or (
            isinstance(instance, float) and instance.is_integer())
    if name == "null":
        return instance is None
    if name == "number":
        return isinstance(instance, (int, float)) \
            and not isinstance(instance, bool)
    if name == "object":
        return isinstance(instance, dict)
    return isinstance(instance, str)


def _type_names(value: Any) -> list[str]:
    names = [value] if isinstance(value, str) else value
    if not isinstance(names, list) or not names or any(
            n not in _TYPES for n in names):
        raise SchemaError(f"bad 'type' value {value!r}")
    return names


def _check_schema(schema: Any) -> None:
    if not isinstance(schema, dict):
        raise SchemaError(f"a schema must be an object, not {schema!r}")
    for k, v in schema.items():
        if k == "type":
            _type_names(v)
        elif k == "required":
            if not isinstance(v, list) or any(
                    not isinstance(p, str) for p in v):
                raise SchemaError(f"bad 'required' value {v!r}")
        elif k == "properties":
            if not isinstance(v, dict):
                raise SchemaError(f"bad 'properties' value {v!r}")
            for sub in v.values():
                _check_schema(sub)
        elif k == "pattern":
            if not isinstance(v, str):
                raise SchemaError(f"bad 'pattern' value {v!r}")
            re.compile(v)
        elif k == "minLength":
            if isinstance(v, bool) or not isinstance(v, int) or v < 0:
                raise SchemaError(f"bad 'minLength' value {v!r}")
        else:
            raise SchemaError(f"JSON-Schema keyword {k!r} is not supported")


def _errors(instance: Any, schema: dict,
            path: tuple = ()) -> Iterator[ValidationError]:
    def err(msg):
        return ValidationError(msg, path=path, instance=instance,
                               schema=schema)

    for k, v in schema.items():
        if k == "type":
            names = _type_names(v)
            if not any(_is_type(instance, n) for n in names):
                yield err(f"{instance!r} is not of type "
                          f"{', '.join(repr(n) for n in names)}")
        elif k == "required":
            if _is_type(instance, "object"):
                for prop in v:
                    if prop not in instance:
                        yield err(f"{prop!r} is a required property")
        elif k == "properties":
            if _is_type(instance, "object"):
                for prop, sub in v.items():
                    if prop in instance:
                        yield from _errors(instance[prop], sub,
                                           path + (prop,))
        elif k == "pattern":
            if _is_type(instance, "string") and not re.search(v, instance):
                yield err(f"{instance!r} does not match {v!r}")
        elif k == "minLength":
            if _is_type(instance, "string") and len(instance) < v:
                yield err(f"{instance!r} "
                          + ("should be non-empty" if v == 1
                             else "is too short"))


def _relevance(e: ValidationError) -> tuple:
    """``jsonschema.exceptions.relevance`` (none of this module's
    keywords is weak or strong there)."""
    expected = e.schema.get("type")
    matches = expected is not None and any(
        _is_type(e.instance, n) for n in _type_names(expected))
    return (-len(e.path), e.path, True, False, not matches)


def validate(instance: Any, schema: dict) -> None:
    """Raise the error ``jsonschema.validate`` would raise, or nothing;
    :class:`SchemaError` first if the schema uses a keyword this module
    does not check."""
    _check_schema(schema)
    errors = list(_errors(instance, schema))
    if errors:
        raise max(errors, key=_relevance)
