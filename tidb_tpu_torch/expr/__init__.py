from .ir import Expr, ColumnRef, Const, ScalarFunc, col, const, func, lit
from .agg import AggDesc, AggMode
from .compile import compile_exprs, CompiledExpr, ExprCompiler, CompVal

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
    "compile_exprs",
    "CompiledExpr",
    "ExprCompiler",
    "CompVal",
]
