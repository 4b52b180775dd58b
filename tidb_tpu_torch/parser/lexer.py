"""SQL lexer — MySQL dialect tokenizer.

The reference embeds a goyacc grammar with a hand-written lexer
(ref: pkg/parser/lexer.go, misc.go keyword table). Here the lexer is a
small hand-rolled scanner producing a flat token list the recursive-descent
parser consumes; same token classes: identifiers (bare + backquoted),
strings ('..', ".." with backslash escapes), numbers (int/float/hex),
operators, parameter markers, comments (--, #, /* */), case-insensitive
keywords.

Copy of `tidb_tpu/parser/lexer.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class T(enum.Enum):
    IDENT = "ident"
    QIDENT = "qident"  # `quoted`
    STRING = "string"
    NUMBER = "number"
    HEX = "hex"
    PARAM = "param"  # ?
    OP = "op"
    HINT = "hint"  # /*+ ... */ optimizer hint body (ref: parser hintparser)
    EOF = "eof"


@dataclass(frozen=True)
class Token:
    kind: T
    text: str
    pos: int  # byte offset, for error messages

    @property
    def upper(self) -> str:
        return self.text.upper()


# Multi-char operators, longest first (ref: lexer.go startWithOp tables).
_OPS3 = ("<=>", "->>")
_OPS2 = ("<=", ">=", "<>", "!=", ":=", "||", "&&", "<<", ">>", "->")
_OPS1 = "+-*/%()=<>,.;@~&|^!"


class LexError(ValueError):
    pass


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            i += 1
            continue
        # comments
        if c == "#" or (c == "-" and sql[i : i + 3] in ("-- ", "--\t", "--\n") or sql[i : i + 2] == "--" and i + 2 == n):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql[i : i + 2] == "/*":
            j = sql.find("*/", i + 2)
            if j < 0:
                raise LexError(f"unterminated comment at {i}")
            # optimizer hint /*+ ... */ — one token carrying the body
            # (ref: pkg/parser hint comments -> hintparser)
            if sql[i + 2 : i + 3] == "+":
                # only a hint right after SELECT reaches the parser; in
                # every other position it degrades to a comment (matching
                # the pre-hint behavior for UPDATE/INSERT/DELETE, whose
                # grammars do not consume hint tokens yet)
                if toks and toks[-1].kind is T.IDENT and toks[-1].upper == "SELECT":
                    toks.append(Token(T.HINT, sql[i + 3 : j].strip(), i))
                i = j + 2
                continue
            # executable comment /*! ... */ — strip markers, lex body
            if sql[i + 2 : i + 3] == "!":
                body = sql[i + 3 : j]
                k = 0
                while k < len(body) and body[k].isdigit():
                    k += 1
                inner = tokenize(body[k:])
                toks.extend(t for t in inner if t.kind is not T.EOF)
            i = j + 2
            continue
        # strings
        if c in ("'", '"'):
            quote = c
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError(f"unterminated string at {i}")
                ch = sql[j]
                if ch == "\\" and j + 1 < n:
                    esc = sql[j + 1]
                    buf.append({"n": "\n", "t": "\t", "r": "\r", "0": "\x00", "b": "\b", "Z": "\x1a"}.get(esc, esc))
                    j += 2
                    continue
                if ch == quote:
                    if sql[j + 1 : j + 2] == quote:  # doubled quote
                        buf.append(quote)
                        j += 2
                        continue
                    break
                buf.append(ch)
                j += 1
            toks.append(Token(T.STRING, "".join(buf), i))
            i = j + 1
            continue
        # backquoted identifier
        if c == "`":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError(f"unterminated identifier at {i}")
                if sql[j] == "`":
                    if sql[j + 1 : j + 2] == "`":
                        buf.append("`")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            toks.append(Token(T.QIDENT, "".join(buf), i))
            i = j + 1
            continue
        # numbers (and leading-dot floats)
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            if c == "0" and sql[i + 1 : i + 2] in ("x", "X"):
                j = i + 2
                while j < n and sql[j] in "0123456789abcdefABCDEF":
                    j += 1
                toks.append(Token(T.HEX, sql[i:j], i))
                i = j
                continue
            j = i
            seen_dot = seen_e = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_e:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_e and j + 1 < n and (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                    seen_e = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            toks.append(Token(T.NUMBER, sql[i:j], i))
            i = j
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_" or c == "$":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] in "_$"):
                j += 1
            toks.append(Token(T.IDENT, sql[i:j], i))
            i = j
            continue
        if c == "?":
            toks.append(Token(T.PARAM, "?", i))
            i += 1
            continue
        op3 = sql[i : i + 3]
        if op3 in _OPS3:
            toks.append(Token(T.OP, op3, i))
            i += 3
            continue
        op2 = sql[i : i + 2]
        if op2 in _OPS2:
            toks.append(Token(T.OP, op2, i))
            i += 2
            continue
        if c in _OPS1:
            toks.append(Token(T.OP, c, i))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r} at {i}")
    toks.append(Token(T.EOF, "", n))
    return toks
