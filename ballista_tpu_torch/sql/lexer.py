"""SQL lexer.

Reference analog: the SQL frontend Ballista delegates to DataFusion's sqlparser
(``BallistaContext::sql``, ``arrow-ballista: ballista/client/src/context.rs:356``).
Hand-written here: the engine targets the TPC-H dialect plus Ballista's DDL
(CREATE EXTERNAL TABLE / SHOW TABLES / EXPLAIN).
"""
from __future__ import annotations

from dataclasses import dataclass

from ballista_tpu_torch.errors import SqlError


@dataclass(frozen=True)
class Token:
    kind: str  # IDENT | NUMBER | STRING | SYM | EOF
    text: str
    pos: int

    @property
    def upper(self) -> str:
        return self.text.upper()


_SYMBOLS = [
    "<>", "<=", ">=", "!=", "||", "(", ")", ",", ";", "+", "-", "*", "/", "%",
    "=", "<", ">", ".",
]


def tokenize(sql: str) -> list[Token]:
    out: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and sql[i : i + 2] == "--":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and sql[j : j + 2] == "''":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise SqlError(f"unterminated string literal at {i}")
            out.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlError(f"unterminated quoted identifier at {i}")
            out.append(Token("IDENT", sql[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (sql[j].isdigit() or (sql[j] == "." and not seen_dot)):
                seen_dot = seen_dot or sql[j] == "."
                j += 1
            if j < n and sql[j] in "eE":
                k = j + 1
                if k < n and sql[k] in "+-":
                    k += 1
                while k < n and sql[k].isdigit():
                    k += 1
                j = k
            out.append(Token("NUMBER", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            out.append(Token("IDENT", sql[i:j], i))
            i = j
            continue
        for s in _SYMBOLS:
            if sql.startswith(s, i):
                out.append(Token("SYM", s, i))
                i += len(s)
                break
        else:
            raise SqlError(f"unexpected character {c!r} at {i}")
    out.append(Token("EOF", "", n))
    return out
