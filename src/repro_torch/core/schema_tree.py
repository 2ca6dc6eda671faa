"""Schema tree + schema ROM (paper §IV-A2).

Preprocessing (verbatim from the paper):

1. Any array/list element type that is not a structure is wrapped into a new
   Struct, so the element of every container is a structure.
2. Struct-typed fields are replaced by their sub-fields (struct inlining), so
   every node is of Bytes, Array or List type only.

After preprocessing, each field corresponds to a node of the *schema tree*;
each Array/List field is the parent of the fields of its element structure.
A special END node is the last child of the root.

The tree is flattened into the *schema ROM*: children of one parent occupy
consecutive entries (visit-next-sibling = index+1), and container entries
store the index of their first child.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .idl import (
    Array,
    Bytes,
    ClientSchema,
    ListT,
    Schema,
    SchemaError,
    StreamT,
    StructRef,
    TypeNode,
    ELEM,
    END,
    START,
)

# node kinds in the ROM
KIND_BYTES = 0
KIND_ARRAY = 1
KIND_LIST = 2
KIND_END = 3
KIND_STREAM = 4

KIND_NAMES = {
    KIND_BYTES: "Bytes",
    KIND_ARRAY: "Array",
    KIND_LIST: "List",
    KIND_END: "END",
    KIND_STREAM: "Stream",
}

#: u32 words of per-fragment metadata a Stream node adds on the wire:
#: ``(stream_id, step, flags)`` — see ``core.stream_plans``.
STREAM_META_WORDS = 3

#: wire width of an Array/List length field (paper: software SER "writes the
#: number of elements"; we fix the count encoding at 4 little-endian bytes).
COUNT_BYTES = 4

#: entries one schema ROM may hold (paper §IV-A2: the ROM is a fixed BRAM;
#: we fix the modeled budget so ``repro.analysis`` can prove a schema fits
#: before any ROM is built)
ROM_CAPACITY = 512

#: context-stack slots of the DES/SER engines (max container nesting the
#: hardware can suspend into; checked statically by ``repro.analysis``)
STACK_CAPACITY = 16


@dataclass
class TreeNode:
    """One node of the (preprocessed) schema tree."""

    kind: int
    path: str  # client-schema token path ("a.elem.x", "" only for END)
    nbytes: int = 0  # payload width for Bytes nodes
    children: List["TreeNode"] = field(default_factory=list)
    is_last: bool = False  # last child of its parent
    # filled in by flattening:
    index: int = -1

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def build_tree(schema: Schema) -> List[TreeNode]:
    """Preprocess `schema` and return the root's children (END included)."""

    def expand(t: TypeNode, path: str) -> List[TreeNode]:
        """Expand one field into tree nodes (inlining structs)."""
        if isinstance(t, Bytes):
            return [TreeNode(KIND_BYTES, path, nbytes=t.n)]
        if isinstance(t, StructRef):
            # transformation 2: inline struct fields
            nodes: List[TreeNode] = []
            for fname, ftype in schema.structs[t.name]:
                sub = f"{path}.{fname}" if path else fname
                nodes.extend(expand(ftype, sub))
            if not nodes:
                raise SchemaError(f"struct {t.name!r} at {path!r} has no fields")
            return nodes
        if isinstance(t, (Array, ListT, StreamT)):
            if isinstance(t, Array):
                kind = KIND_ARRAY
            elif isinstance(t, ListT):
                kind = KIND_LIST
            else:
                kind = KIND_STREAM
            # transformation 1: wrap non-struct element into a struct.  The
            # wrapped field keeps the container's `elem` path so tags resolve.
            children = expand(t.elem, f"{path}.{ELEM}")
            for c in children:
                c.is_last = False
            children[-1].is_last = True
            return [TreeNode(kind, path, children=children)]
        raise SchemaError(f"bad type {t!r}")

    top_nodes: List[TreeNode] = []
    for fname, ftype in schema.structs[schema.top]:
        top_nodes.extend(expand(ftype, fname))
    end = TreeNode(KIND_END, "")
    top_nodes.append(end)
    for n in top_nodes:
        n.is_last = False
    top_nodes[-1].is_last = True
    return top_nodes


def tree_depth(roots: List[TreeNode]) -> int:
    """Maximum container nesting depth (size needed for the context stack)."""

    def d(n: TreeNode) -> int:
        if n.kind in (KIND_ARRAY, KIND_LIST, KIND_STREAM):
            return 1 + max((d(c) for c in n.children), default=0)
        return 0

    return max((d(n) for n in roots), default=0)


# ---------------------------------------------------------------------------
# Schema ROM
# ---------------------------------------------------------------------------


@dataclass
class SchemaROM:
    """Flat encoding of the schema tree (paper: 'schema ROM').

    Arrays are indexed by ROM entry.  Siblings are consecutive, so "visit next
    sibling" is ``index + 1``; `last` marks the final child of a parent.
    Container entries store `child` = index of their first child.

    `emit_end` is 1 when the DES logic must emit the array-end token (always 1
    for Lists; for Arrays only when the client schema tags the `end` path —
    paper §III-C1).  `tag`/`tag_start`/`tag_end` come from the client schema
    (-1 = untagged).  `list_level` counts enclosing List contexts *including*
    the node itself when it is a List (used by the HW-to-HW framing protocol).
    """

    kind: np.ndarray  # int32[N]
    nbytes: np.ndarray  # int32[N]  (Bytes payload width; COUNT_BYTES for containers)
    child: np.ndarray  # int32[N]  (-1 for leaves)
    last: np.ndarray  # int32[N]
    tag: np.ndarray  # int32[N]
    tag_start: np.ndarray  # int32[N]
    tag_end: np.ndarray  # int32[N]
    emit_end: np.ndarray  # int32[N]
    list_level: np.ndarray  # int32[N]
    depth: np.ndarray  # int32[N] container nesting depth of the node
    paths: List[str]  # debug / tooling
    stack_depth: int  # max context-stack depth needed
    root_first: int = 0  # ROM index of the root's first child (always 0)

    @property
    def n_nodes(self) -> int:
        return int(self.kind.shape[0])

    @property
    def max_token_bytes(self) -> int:
        """Widest token payload (bytes)."""
        widths = [COUNT_BYTES]
        widths += [int(b) for k, b in zip(self.kind, self.nbytes) if k == KIND_BYTES]
        return max(widths)

    def static_bounds(self) -> dict:
        """Static resource demands vs. the modeled hardware capacities —
        the numbers the ``repro.analysis`` schema pass compares against
        :data:`ROM_CAPACITY` / :data:`STACK_CAPACITY` / the u8 ListLevel
        header lane."""
        return {
            "n_nodes": self.n_nodes,
            "rom_capacity": ROM_CAPACITY,
            "stack_depth": int(self.stack_depth),
            "stack_capacity": STACK_CAPACITY,
            "max_token_bytes": self.max_token_bytes,
            "max_list_level": int(np.max(self.list_level, initial=0)),
            "n_streams": int(np.sum(self.kind == KIND_STREAM)),
            "stream_meta_words": STREAM_META_WORDS,
        }

    def describe(self) -> str:
        rows = ["idx kind   bytes child last emit_end lvl tag  path"]
        for i in range(self.n_nodes):
            rows.append(
                f"{i:3d} {KIND_NAMES[int(self.kind[i])]:6s} {int(self.nbytes[i]):5d} "
                f"{int(self.child[i]):5d} {int(self.last[i]):4d} "
                f"{int(self.emit_end[i]):8d} {int(self.list_level[i]):3d} "
                f"{int(self.tag[i]):4d} {self.paths[i]}"
            )
        return "\n".join(rows)


def build_rom(schema: Schema, client: Optional[ClientSchema] = None) -> SchemaROM:
    """Compile a central schema (+ optional client schema) into a SchemaROM."""
    client = client or ClientSchema()
    client.validate_against(schema)
    roots = build_tree(schema)

    # breadth-of-children flattening: emit each sibling group contiguously.
    order: List[TreeNode] = []

    def place(group: List[TreeNode]) -> None:
        start = len(order)
        for off, n in enumerate(group):
            n.index = start + off
        order.extend(group)
        for n in group:
            if n.children:
                place(n.children)

    place(roots)

    n = len(order)
    kind = np.full(n, KIND_BYTES, np.int32)
    nbytes = np.zeros(n, np.int32)
    child = np.full(n, -1, np.int32)
    last = np.zeros(n, np.int32)
    tag = np.full(n, -1, np.int32)
    tag_start = np.full(n, -1, np.int32)
    tag_end = np.full(n, -1, np.int32)
    emit_end = np.zeros(n, np.int32)
    list_level = np.zeros(n, np.int32)
    depth = np.zeros(n, np.int32)
    paths = [nd.path for nd in order]

    # container-depth / list-level by re-walking the tree.
    def annotate(group: List[TreeNode], d: int, ll: int) -> None:
        for nd in group:
            depth[nd.index] = d
            # a Stream is an incremental List: it rides ListLevel-tagged
            # lanes, so it counts toward the list level like a List does.
            if nd.kind in (KIND_LIST, KIND_STREAM):
                list_level[nd.index] = ll + 1
            else:
                list_level[nd.index] = ll
            if nd.children:
                annotate(nd.children, d + 1, int(list_level[nd.index]))

    annotate(roots, 0, 0)

    for nd in order:
        i = nd.index
        kind[i] = nd.kind
        last[i] = int(nd.is_last)
        if nd.kind == KIND_BYTES:
            nbytes[i] = nd.nbytes
            tag[i] = client.tag_for(nd.path)
        elif nd.kind in (KIND_ARRAY, KIND_LIST, KIND_STREAM):
            nbytes[i] = COUNT_BYTES
            child[i] = nd.children[0].index
            tag_start[i] = client.tag_for(f"{nd.path}.{START}")
            tag_end[i] = client.tag_for(f"{nd.path}.{END}")
            if nd.kind in (KIND_LIST, KIND_STREAM):
                emit_end[i] = 1  # lists/streams always emit list-end (EOS)
            else:
                emit_end[i] = int(tag_end[i] >= 0)  # arrays: only when tagged
        # END node: all defaults

    return SchemaROM(
        kind=kind,
        nbytes=nbytes,
        child=child,
        last=last,
        tag=tag,
        tag_start=tag_start,
        tag_end=tag_end,
        emit_end=emit_end,
        list_level=list_level,
        depth=depth,
        paths=paths,
        stack_depth=max(1, tree_depth(roots)),
    )
