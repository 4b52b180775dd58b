from .ir import Expr, ColumnRef, Const, ScalarFunc, col, const, func, lit
from .agg import AggDesc, AggMode
from .compile import ExprCompiler, CompVal

__all__ = [
    "Expr",
    "ColumnRef",
    "Const",
    "ScalarFunc",
    "col",
    "const",
    "func",
    "lit",
    "AggDesc",
    "AggMode",
    "ExprCompiler",
    "CompVal",
]
