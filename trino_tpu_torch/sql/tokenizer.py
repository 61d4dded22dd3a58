"""SQL tokenizer.

Reference parity: the lexer rules of core/trino-parser's SqlBase.g4
(IDENTIFIER, QUOTED_IDENTIFIER, STRING, DECIMAL_VALUE, comments, operator
tokens). Produces a flat token list consumed by the recursive-descent
parser.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


class ParseError(ValueError):
    """Syntax error (reference: spi/StandardErrorCode SYNTAX_ERROR)."""

    def __init__(self, message: str, line: int = 0, column: int = 0):
        super().__init__(
            f"line {line}:{column}: {message}" if line else message)
        self.line = line
        self.column = column


@dataclass(frozen=True)
class Token:
    kind: str     # ident | qident | string | integer | decimal | float | op | eof
    value: str    # normalized text (idents lower-cased unless quoted)
    line: int
    column: int

    def upper(self) -> str:
        return self.value.upper()


_MULTI_OPS = ("<>", "!=", "<=", ">=", "||", "->", "=>")
_SINGLE_OPS = "+-*/%<>=(),.;[]?:"


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    i, n = 0, len(sql)
    line, col = 1, 1

    def advance(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and sql[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            advance(1)
            continue
        if c == "-" and sql[i:i + 2] == "--":
            j = sql.find("\n", i)
            advance((j if j >= 0 else n) - i)
            continue
        if c == "/" and sql[i:i + 2] == "/*":
            j = sql.find("*/", i + 2)
            if j < 0:
                raise ParseError("unterminated comment", line, col)
            advance(j + 2 - i)
            continue
        tl, tc = line, col
        if c == "'":
            # string literal, '' escapes a quote
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise ParseError("unterminated string", tl, tc)
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token("string", "".join(buf), tl, tc))
            advance(j + 1 - i)
            continue
        if c == '"':
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise ParseError("unterminated identifier", tl, tc)
                if sql[j] == '"':
                    if j + 1 < n and sql[j + 1] == '"':
                        buf.append('"')
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token("qident", "".join(buf), tl, tc))
            advance(j + 1 - i)
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                        sql[j + 1].isdigit() or
                        (sql[j + 1] in "+-" and j + 2 < n
                         and sql[j + 2].isdigit())):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            text = sql[i:j]
            kind = ("float" if seen_exp
                    else "decimal" if seen_dot else "integer")
            tokens.append(Token(kind, text, tl, tc))
            advance(j - i)
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            tokens.append(Token("ident", sql[i:j].lower(), tl, tc))
            advance(j - i)
            continue
        two = sql[i:i + 2]
        if two in _MULTI_OPS:
            tokens.append(Token("op", two, tl, tc))
            advance(2)
            continue
        if c in _SINGLE_OPS:
            tokens.append(Token("op", c, tl, tc))
            advance(1)
            continue
        raise ParseError(f"unexpected character {c!r}", tl, tc)
    tokens.append(Token("eof", "", line, col))
    return tokens
