"""Proto drift check: verify each checked-in ``*_pb2.py`` matches its
``.proto`` source. The port's copy of ``ballista_tpu/analysis/proto_drift.py``,
over the port's own ``proto/`` and its ``ballista_tpu_torch.proto`` modules.

The generated modules are committed (the build image carries no ``protoc``),
so nothing structural stops someone from editing a ``.proto`` without
regenerating — the wire format would silently diverge from the documented
contract. This check parses the ``.proto`` text with a minimal tokenizer
(messages, nested messages, enums, oneofs, maps; field names and numbers)
and diffs it against the generated module's descriptor pool.

Run::

    python -m ballista_tpu_torch.analysis.proto_drift [proto_dir]
"""
from __future__ import annotations

import importlib
import os
import re
import sys
from dataclasses import dataclass, field

PROTO_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "proto")

_SCALARS = {
    "double", "float", "int32", "int64", "uint32", "uint64", "sint32",
    "sint64", "fixed32", "fixed64", "sfixed32", "sfixed64", "bool", "string",
    "bytes",
}


@dataclass
class ProtoMessage:
    name: str
    # field name -> (number, label, type token); maps store type "map"
    fields: dict[str, tuple[int, str, str]] = field(default_factory=dict)
    nested: dict[str, "ProtoMessage"] = field(default_factory=dict)
    enums: dict[str, dict[str, int]] = field(default_factory=dict)


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _tokenize(text: str) -> list[str]:
    return re.findall(r"[A-Za-z_][\w.]*|\d+|[{}=;<>,\[\]]|\"[^\"]*\"", text)


class _Parser:
    def __init__(self, tokens: list[str]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> str:
        return self.toks[self.i] if self.i < len(self.toks) else ""

    def next(self) -> str:
        t = self.peek()
        self.i += 1
        return t

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise ValueError(f"proto parse: expected {tok!r}, got {got!r} at {self.i}")

    def skip_to_semicolon(self) -> None:
        while self.peek() not in (";", ""):
            self.next()
        self.next()

    def skip_block(self) -> None:
        self.expect("{")
        depth = 1
        while depth and self.peek():
            t = self.next()
            if t == "{":
                depth += 1
            elif t == "}":
                depth -= 1

    def parse_file(self) -> dict[str, ProtoMessage]:
        messages: dict[str, ProtoMessage] = {}
        while self.peek():
            t = self.next()
            if t == "message":
                m = self.parse_message(self.next())
                messages[m.name] = m
            elif t == "enum":
                self.next()
                self.skip_block()
            elif t == "service":
                self.next()
                self.skip_block()
            elif t in ("syntax", "package", "option", "import"):
                self.skip_to_semicolon()
            # stray tokens (e.g. semicolons) are skipped
        return messages

    def parse_message(self, name: str) -> ProtoMessage:
        msg = ProtoMessage(name)
        self.expect("{")
        while True:
            t = self.next()
            if t == "}":
                return msg
            if t == "message":
                nested = self.parse_message(self.next())
                msg.nested[nested.name] = nested
            elif t == "enum":
                ename = self.next()
                msg.enums[ename] = self.parse_enum_body()
            elif t == "oneof":
                self.next()  # oneof name: fields inside count as plain fields
                self.expect("{")
                while self.peek() != "}":
                    self.parse_field(msg, self.next())
                self.expect("}")
            elif t == "option":
                self.skip_to_semicolon()
            elif t == "reserved":
                self.skip_to_semicolon()
            elif t == ";":
                continue
            else:
                self.parse_field(msg, t)

    def parse_enum_body(self) -> dict[str, int]:
        values: dict[str, int] = {}
        self.expect("{")
        while self.peek() != "}":
            name = self.next()
            if name == "option":
                self.skip_to_semicolon()
                continue
            self.expect("=")
            values[name] = int(self.next())
            if self.peek() == "[":
                while self.next() != "]":
                    pass
            if self.peek() == ";":
                self.next()
        self.next()
        return values

    def parse_field(self, msg: ProtoMessage, first: str) -> None:
        label = "optional"
        t = first
        if t in ("repeated", "optional", "required"):
            label = t
            t = self.next()
        if t == "map":
            self.expect("<")
            self.next()  # key type
            self.expect(",")
            self.next()  # value type
            self.expect(">")
            fname = self.next()
            ftype = "map"
            label = "map"
        else:
            ftype = t
            fname = self.next()
        self.expect("=")
        number = int(self.next())
        if self.peek() == "[":
            while self.next() != "]":
                pass
        if self.peek() == ";":
            self.next()
        msg.fields[fname] = (number, label, ftype)


def parse_proto_text(text: str) -> dict[str, ProtoMessage]:
    return _Parser(_tokenize(_strip_comments(text))).parse_file()


# ---- descriptor side --------------------------------------------------------------
def _descriptor_message(desc) -> ProtoMessage:
    from google.protobuf import descriptor as D

    msg = ProtoMessage(desc.name)
    for f in desc.fields:
        if (
            f.type == D.FieldDescriptor.TYPE_MESSAGE
            and f.message_type.GetOptions().map_entry
        ):
            msg.fields[f.name] = (f.number, "map", "map")
            continue
        # protobuf >= 5.29 deprecates .label for is_repeated/is_required,
        # which flipped from method to property across releases
        rep = getattr(f, "is_repeated", None)
        req = getattr(f, "is_required", None)
        if rep is not None:
            rep = rep() if callable(rep) else rep
            req = (req() if callable(req) else req) if req is not None else False
            label = "repeated" if rep else ("required" if req else "optional")
        else:
            label = {
                D.FieldDescriptor.LABEL_OPTIONAL: "optional",
                D.FieldDescriptor.LABEL_REPEATED: "repeated",
                D.FieldDescriptor.LABEL_REQUIRED: "required",
            }[f.label]
        if f.type == D.FieldDescriptor.TYPE_MESSAGE:
            ftype = f.message_type.name
        elif f.type == D.FieldDescriptor.TYPE_ENUM:
            ftype = f.enum_type.name
        else:
            ftype = {
                D.FieldDescriptor.TYPE_DOUBLE: "double",
                D.FieldDescriptor.TYPE_FLOAT: "float",
                D.FieldDescriptor.TYPE_INT32: "int32",
                D.FieldDescriptor.TYPE_INT64: "int64",
                D.FieldDescriptor.TYPE_UINT32: "uint32",
                D.FieldDescriptor.TYPE_UINT64: "uint64",
                D.FieldDescriptor.TYPE_SINT32: "sint32",
                D.FieldDescriptor.TYPE_SINT64: "sint64",
                D.FieldDescriptor.TYPE_FIXED32: "fixed32",
                D.FieldDescriptor.TYPE_FIXED64: "fixed64",
                D.FieldDescriptor.TYPE_SFIXED32: "sfixed32",
                D.FieldDescriptor.TYPE_SFIXED64: "sfixed64",
                D.FieldDescriptor.TYPE_BOOL: "bool",
                D.FieldDescriptor.TYPE_STRING: "string",
                D.FieldDescriptor.TYPE_BYTES: "bytes",
            }.get(f.type, f"type{f.type}")
        msg.fields[f.name] = (f.number, label, ftype)
    for nested in desc.nested_types:
        if nested.GetOptions().map_entry:
            continue  # synthetic MapEntry types have no .proto counterpart
        msg.nested[nested.name] = _descriptor_message(nested)
    for e in desc.enum_types:
        msg.enums[e.name] = {v.name: v.number for v in e.values}
    return msg


def _diff_message(path: str, want: ProtoMessage, got: ProtoMessage,
                  problems: list[str]) -> None:
    for fname, (num, label, ftype) in want.fields.items():
        if fname not in got.fields:
            problems.append(f"{path}.{fname}: in .proto but not in _pb2")
            continue
        gnum, glabel, gtype = got.fields[fname]
        if gnum != num:
            problems.append(
                f"{path}.{fname}: field number {num} in .proto, {gnum} in _pb2")
        if glabel != label:
            problems.append(
                f"{path}.{fname}: label {label!r} in .proto, {glabel!r} in _pb2")
        if ftype != "map" and gtype != ftype and ftype.split(".")[-1] != gtype:
            problems.append(
                f"{path}.{fname}: type {ftype!r} in .proto, {gtype!r} in _pb2")
    for fname in got.fields:
        if fname not in want.fields:
            problems.append(f"{path}.{fname}: in _pb2 but not in .proto")
    for name, sub in want.nested.items():
        if name not in got.nested:
            problems.append(f"{path}.{name}: nested message missing from _pb2")
        else:
            _diff_message(f"{path}.{name}", sub, got.nested[name], problems)
    for name in got.nested:
        if name not in want.nested:
            problems.append(f"{path}.{name}: nested message missing from .proto")
    for name, values in want.enums.items():
        gvals = got.enums.get(name)
        if gvals is None:
            problems.append(f"{path}.{name}: enum missing from _pb2")
        elif gvals != values:
            problems.append(f"{path}.{name}: enum values differ "
                            f"({values} vs {gvals})")


def check_proto_module(proto_path: str, pb2_module) -> list[str]:
    """Diff one .proto file against its generated module. Returns problems."""
    with open(proto_path, encoding="utf-8") as fh:
        want = parse_proto_text(fh.read())
    got = {
        name: _descriptor_message(desc)
        for name, desc in pb2_module.DESCRIPTOR.message_types_by_name.items()
    }
    problems: list[str] = []
    base = os.path.basename(proto_path)
    for name, wmsg in want.items():
        if name not in got:
            problems.append(f"{base}: message {name} missing from _pb2")
        else:
            _diff_message(f"{base}:{name}", wmsg, got[name], problems)
    for name in got:
        if name not in want:
            problems.append(f"{base}: message {name} in _pb2 but not in .proto")
    return problems


def check_all(proto_dir: str = PROTO_DIR) -> dict[str, list[str]]:
    """Check every <name>.proto / <name>_pb2.py pair in the proto package."""
    results: dict[str, list[str]] = {}
    for fname in sorted(os.listdir(proto_dir)):
        if not fname.endswith(".proto"):
            continue
        stem = fname[:-6]
        mod_name = f"ballista_tpu_torch.proto.{stem}_pb2"
        try:
            mod = importlib.import_module(mod_name)
        except ImportError as e:
            results[fname] = [f"{fname}: cannot import {mod_name}: {e}"]
            continue
        results[fname] = check_proto_module(os.path.join(proto_dir, fname), mod)
    return results


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    proto_dir = argv[0] if argv else PROTO_DIR
    results = check_all(proto_dir)
    bad = 0
    for fname, problems in results.items():
        if problems:
            bad += 1
            print(f"DRIFT {fname}:")
            for p in problems:
                print(f"  {p}")
        else:
            print(f"ok    {fname}")
    if bad:
        print(f"\n{bad} proto file(s) drifted from their generated _pb2 module."
              "\nEdit the .proto AND regenerate (or re-splice) the _pb2 together.")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
