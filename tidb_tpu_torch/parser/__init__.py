"""SQL front end: lexer, AST, recursive-descent MySQL parser
(ref: pkg/parser — goyacc grammar parser.y + ast/).

Copy of `tidb_tpu/parser/__init__.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from . import ast
from .lexer import LexError, tokenize
from .parser import ParseError, parse, parse_expr, parse_one

__all__ = ["ast", "tokenize", "LexError", "ParseError", "parse", "parse_one", "parse_expr"]
