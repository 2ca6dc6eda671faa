"""HGum IDL: JSON schema grammar, parsing and validation (paper §III-B).

Grammar (Fig. 5 of the paper)::

    schema    ::= { structName : structDef, ... }
    structDef ::= [ [fieldName, type], ... ]
    type      ::= ["Bytes", n] | ["Struct", structName]
                | ["Array", type] | ["List", type] | ["Stream", type]

The *central schema* is shared by sender and receiver.  A *client schema*
(paper §III-C1, Fig. 7) assigns integer tags to token paths and is private to
one DES module; multiple client schemas may exist for one central schema.

``["Stream", t]`` extends the paper grammar: a List whose elements are
emitted incrementally across ticks.  Each fragment on the wire carries
``(stream_id, step, flags)`` metadata and keeps the §IV-B
count-after-elements convention, so bursts of fragments still parse
back-to-front.  Chunk codecs for streams are *generated* from the schema
(see ``core.stream_plans``), never hand-written.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple, Union


class SchemaError(ValueError):
    """Raised for malformed schema / client-schema definitions."""


# ---------------------------------------------------------------------------
# Type AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Bytes:
    """``["Bytes", n]`` — an n-byte scalar field (byte width configurable)."""

    n: int

    def __post_init__(self):
        if not isinstance(self.n, int) or self.n <= 0:
            raise SchemaError(f"Bytes width must be a positive int, got {self.n!r}")


@dataclass(frozen=True)
class StructRef:
    """``["Struct", name]`` — reference to a named structure."""

    name: str


@dataclass(frozen=True)
class Array:
    """``["Array", t]`` — length known before any element is serialized."""

    elem: "TypeNode"


@dataclass(frozen=True)
class ListT:
    """``["List", t]`` — length unknown until the last element is serialized."""

    elem: "TypeNode"


@dataclass(frozen=True)
class StreamT:
    """``["Stream", t]`` — a List emitted incrementally across ticks.

    Elements travel as chunk fragments tagged ``(stream_id, step, flags)``;
    the element type must be fixed-size (no nested containers) so the chunk
    codec can be generated with static bounds.
    """

    elem: "TypeNode"


TypeNode = Union[Bytes, StructRef, Array, ListT, StreamT]

_CONTAINER = (Array, ListT, StreamT)


def parse_type(obj) -> TypeNode:
    """Parse one ``type`` production from its JSON form."""
    if (not isinstance(obj, (list, tuple))) or len(obj) != 2:
        raise SchemaError(f"type must be a 2-element list, got {obj!r}")
    kind, arg = obj
    if kind == "Bytes":
        if not isinstance(arg, int):
            raise SchemaError(f"Bytes arg must be int, got {arg!r}")
        return Bytes(arg)
    if kind == "Struct":
        if not isinstance(arg, str):
            raise SchemaError(f"Struct arg must be a name, got {arg!r}")
        return StructRef(arg)
    if kind == "Array":
        return Array(parse_type(arg))
    if kind == "List":
        return ListT(parse_type(arg))
    if kind == "Stream":
        return StreamT(parse_type(arg))
    raise SchemaError(f"unknown type constructor {kind!r}")


def type_to_json(t: TypeNode):
    if isinstance(t, Bytes):
        return ["Bytes", t.n]
    if isinstance(t, StructRef):
        return ["Struct", t.name]
    if isinstance(t, Array):
        return ["Array", type_to_json(t.elem)]
    if isinstance(t, ListT):
        return ["List", type_to_json(t.elem)]
    if isinstance(t, StreamT):
        return ["Stream", type_to_json(t.elem)]
    raise SchemaError(f"not a type node: {t!r}")


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


@dataclass
class Schema:
    """A parsed central schema: named structs, one of which is the message."""

    structs: Dict[str, List[Tuple[str, TypeNode]]]
    top: str  # the message struct name

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_json(obj, top: str | None = None) -> "Schema":
        if isinstance(obj, str):
            obj = json.loads(obj)
        if not isinstance(obj, dict) or not obj:
            raise SchemaError("schema must be a non-empty JSON object")
        structs: Dict[str, List[Tuple[str, TypeNode]]] = {}
        for sname, sdef in obj.items():
            if not isinstance(sdef, (list, tuple)):
                raise SchemaError(f"structDef of {sname!r} must be a list")
            fields: List[Tuple[str, TypeNode]] = []
            seen = set()
            for f in sdef:
                if not isinstance(f, (list, tuple)) or len(f) != 2:
                    raise SchemaError(f"field of {sname!r} must be [name, type]: {f!r}")
                fname, ftype = f
                if not isinstance(fname, str) or not fname:
                    raise SchemaError(f"bad field name {fname!r} in {sname!r}")
                if fname in seen:
                    raise SchemaError(f"duplicate field {fname!r} in {sname!r}")
                seen.add(fname)
                fields.append((fname, parse_type(ftype)))
            structs[sname] = fields
        if top is None:
            # Paper: "The structName of the top level structure should match
            # the name of the message."  With one struct it is unambiguous;
            # otherwise the first key is the message (JSON objects are ordered).
            top = next(iter(obj))
        schema = Schema(structs=structs, top=top)
        schema.validate()
        return schema

    def to_json(self) -> dict:
        return {
            s: [[fn, type_to_json(ft)] for fn, ft in fl]
            for s, fl in self.structs.items()
        }

    # -- validation --------------------------------------------------------

    def validate(self) -> None:
        if self.top not in self.structs:
            raise SchemaError(f"top-level struct {self.top!r} is not defined")
        # every StructRef resolves; no recursive struct cycles (a message is
        # finite; recursion would make the schema tree infinite).
        for sname, fields in self.structs.items():
            for fname, ftype in fields:
                self._check_refs(ftype, f"{sname}.{fname}")
        self._check_acyclic(self.top, stack=())

    def _check_refs(self, t: TypeNode, where: str) -> None:
        if isinstance(t, StructRef):
            if t.name not in self.structs:
                raise SchemaError(f"{where}: undefined struct {t.name!r}")
        elif isinstance(t, _CONTAINER):
            self._check_refs(t.elem, where + "[]")

    def _struct_deps(self, t: TypeNode):
        if isinstance(t, StructRef):
            yield t.name
        elif isinstance(t, _CONTAINER):
            yield from self._struct_deps(t.elem)

    def _check_acyclic(self, sname: str, stack: tuple) -> None:
        if sname in stack:
            raise SchemaError(
                f"recursive struct cycle: {' -> '.join(stack + (sname,))}"
            )
        for fname, ftype in self.structs[sname]:
            for dep in self._struct_deps(ftype):
                self._check_acyclic(dep, stack + (sname,))

    # -- convenience -------------------------------------------------------

    def resolve(self, t: TypeNode) -> TypeNode:
        """Follow a StructRef one level (no-op for other nodes)."""
        return t

    def max_depth(self) -> int:
        """Maximum container (Array/List/Stream) nesting depth of the message."""

        def depth_of(t: TypeNode) -> int:
            if isinstance(t, Bytes):
                return 0
            if isinstance(t, StructRef):
                return max(
                    (depth_of(ft) for _, ft in self.structs[t.name]), default=0
                )
            if isinstance(t, _CONTAINER):
                return 1 + depth_of(t.elem)
            raise SchemaError(f"bad type {t!r}")

        return max((depth_of(ft) for _, ft in self.structs[self.top]), default=0)


# ---------------------------------------------------------------------------
# Client schema (token tags, paper Fig. 7)
# ---------------------------------------------------------------------------

START = "start"  # array-length / list-begin token of a container
END = "end"  # array-end / list-end token of a container
ELEM = "elem"  # descend into the container's element


@dataclass
class ClientSchema:
    """Maps token paths (e.g. ``a.elem.elem.x``, ``a.start``) to integer tags.

    Per the paper, defining an ``end`` tag for an Array makes the DES logic
    emit the (otherwise optional) array-end token.  Lists always emit
    list-begin/list-end.  Tags are small non-negative ints.
    """

    tags: Dict[str, int] = field(default_factory=dict)

    @staticmethod
    def from_json(obj) -> "ClientSchema":
        if isinstance(obj, str):
            obj = json.loads(obj)
        if not isinstance(obj, dict):
            raise SchemaError("client schema must be a JSON object")
        tags = {}
        for path, tag in obj.items():
            if not isinstance(path, str) or not path:
                raise SchemaError(f"bad token path {path!r}")
            if not isinstance(tag, int) or tag < 0:
                raise SchemaError(f"tag for {path!r} must be a non-negative int")
            tags[path] = tag
        cs = ClientSchema(tags)
        cs.validate()
        return cs

    def validate(self) -> None:
        """Tags must be unique: the DES emits (tag, value) pairs, so two
        paths sharing a tag make its output ambiguous."""
        by_tag: Dict[int, List[str]] = {}
        for path, tag in self.tags.items():
            by_tag.setdefault(tag, []).append(path)
        for tag, paths in sorted(by_tag.items()):
            if len(paths) > 1:
                raise SchemaError(
                    f"client-schema tag {tag} is shared by paths "
                    f"{sorted(paths)}"
                )

    def to_json(self) -> dict:
        return dict(self.tags)

    def tag_for(self, path: str) -> int:
        """Tag for a token path, or -1 when unspecified."""
        return self.tags.get(path, -1)

    def validate_against(self, schema: Schema) -> None:
        """Every tag path must name a real token of the schema."""
        valid = set(all_token_paths(schema))
        for path in self.tags:
            if path not in valid:
                raise SchemaError(
                    f"client-schema path {path!r} does not name a token; "
                    f"valid paths include e.g. {sorted(valid)[:6]}"
                )


def all_token_paths(schema: Schema) -> List[str]:
    """Enumerate every legal token path of a schema (pre-preprocessing view)."""
    out: List[str] = []

    def walk(t: TypeNode, prefix: str) -> None:
        if isinstance(t, Bytes):
            out.append(prefix)
        elif isinstance(t, StructRef):
            for fname, ftype in schema.structs[t.name]:
                walk(ftype, f"{prefix}.{fname}" if prefix else fname)
        elif isinstance(t, _CONTAINER):
            out.append(f"{prefix}.{START}")
            out.append(f"{prefix}.{END}")
            walk(t.elem, f"{prefix}.{ELEM}")
        else:  # pragma: no cover
            raise SchemaError(f"bad type {t!r}")

    for fname, ftype in schema.structs[schema.top]:
        walk(ftype, fname)
    return out
