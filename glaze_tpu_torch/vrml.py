"""VRML97 (.wrl) importer: parses the classic encoding into the same
element tree shape X3D uses and reuses the X3D extraction pipeline
(glaze_tpu_torch.x3d) — VRML is the classic encoding of the X3D scene graph,
so node and field names map 1:1 (Transform/Shape/Appearance/Material/
ImageTexture/IndexedFaceSet/Coordinate/Viewpoint/PointLight/...).

The reference reaches .wrl through assimp (converter/src/main.rs:86-102).

Grammar subset: ``[DEF name] NodeType { field value ... }`` where a
field value is a scalar, a quoted string, a bracketed number/string
list, a nested node, ``USE name``, or a bracketed node list (e.g.
``children [ ... ]``). Node-valued fields become child elements (the
field name itself is dropped — matching X3D's containerField default);
everything else becomes an attribute string.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET


_TOKEN = re.compile(
    r'"(?:[^"\\]|\\.)*"'      # quoted string
    r"|[{}\[\]]"              # brackets
    r"|[^\s,{}\[\]]+"         # atom (commas are whitespace in VRML)
)


def _tokens(text):
    # strip # comments (outside strings: VRML strings rarely hold '#'
    # paths; handle the common case by scanning line-wise)
    out = []
    for line in text.splitlines():
        pos = 0
        in_str = False
        for i, ch in enumerate(line):
            if ch == '"':
                in_str = not in_str
            elif ch == "#" and not in_str:
                line = line[:i]
                break
        out.extend(_TOKEN.findall(line))
    return out


_NODE_NAME = re.compile(r"^[A-Za-z][A-Za-z0-9_]*$")


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0
        self.defs = {}

    def peek(self, k=0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of VRML file")
        self.i += 1
        return t

    def parse_node(self):
        """[DEF name] Type { ... } | USE name -> ET.Element"""
        t = self.next()
        if t == "DEF":
            name = self.next()
            node = self.parse_node()
            node.set("DEF", name)
            self.defs[name] = node
            return node
        if t == "USE":
            name = self.next()
            el = ET.Element("USE_REF")
            el.set("USE", name)
            return el
        if not _NODE_NAME.match(t):
            raise ValueError(f"expected a VRML node type, got {t!r}")
        if self.next() != "{":
            raise ValueError(f"expected '{{' after node type {t}")
        el = ET.Element(t)
        while True:
            f = self.next()
            if f == "}":
                return el
            self.parse_field(el, f)

    def parse_field(self, el, field):
        nxt = self.peek()
        if nxt is None:
            raise ValueError(f"field {field!r} has no value")
        if nxt == "[":
            self.next()
            vals = []
            while self.peek() not in ("]", None):
                if self.peek() in ("DEF", "USE") or (
                        _NODE_NAME.match(self.peek() or "")
                        and self.peek(1) == "{"):
                    el.append(self._retag(self.parse_node(), field))
                else:
                    vals.append(self.next())
            if self.next() != "]":
                raise ValueError(f"unterminated [ list for {field!r}")
            if vals:
                el.set(field, " ".join(v.strip('"') for v in vals))
            return
        if nxt in ("DEF", "USE") or (
                _NODE_NAME.match(nxt) and self.peek(1) == "{"):
            el.append(self._retag(self.parse_node(), field))
            return
        # scalar run: consume numbers/strings until the next field name,
        # node, or bracket. VRML vec fields are fixed-width but counting
        # is unnecessary: a field name is followed by a value token, so
        # an atom followed by '{' or a known keyword ends the run.
        vals = [self.next()]
        while True:
            t = self.peek()
            if t is None or t in ("}", "]", "["):
                break
            if t in ("DEF", "USE"):
                break
            if _NODE_NAME.match(t) and not _is_number(t):
                break  # next field name (or node type)
            vals.append(self.next())
        el.set(field, " ".join(v.strip('"') for v in vals))

    @staticmethod
    def _retag(node, field):
        """USE references keep their tag; the field name is dropped
        (geometry/appearance/children map to the node's own type)."""
        return node


def _is_number(t):
    try:
        float(t)
        return True
    except ValueError:
        return False


def _resolve_uses(root, defs):
    """Replaces USE_REF placeholders with the DEF'd element (shared —
    the X3D walker treats repeated ids as instanced geometry)."""
    for parent in root.iter():
        for i, child in enumerate(list(parent)):
            if child.tag == "USE_REF":
                name = child.get("USE")
                target = defs.get(name)
                if target is None:
                    raise ValueError(
                        f"VRML USE references unknown DEF {name!r}")
                parent.remove(child)
                parent.insert(i, target)
    return root


def parse_vrml(path):
    """VRML text -> an X3D-shaped <Scene> element tree."""
    with open(path, "r", errors="replace") as f:
        text = f.read()
    if not text.lstrip().startswith("#VRML"):
        raise ValueError("not a VRML file (missing #VRML header)")
    # the header line is a comment, already stripped by the tokenizer
    p = _Parser(_tokens(text))
    scene = ET.Element("Scene")
    while p.peek() is not None:
        scene.append(p.parse_node())
    return _resolve_uses(scene, p.defs)


def import_wrl(path):
    """VRML97 -> the common importer contract (via the X3D pipeline)."""
    import os

    from glaze_tpu_torch import x3d

    root = ET.Element("X3D")
    root.append(parse_vrml(path))
    return x3d.import_x3d_tree(
        root, os.path.dirname(os.path.abspath(path)))
