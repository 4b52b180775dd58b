"""AST node definitions (ref: pkg/parser/ast — expressions.go, dml.go,
ddl.go, misc.go). Plain dataclasses; the planner walks these.

Copy of `tidb_tpu/parser/ast.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------- expressions


class ExprNode:
    __slots__ = ()


@dataclass
class Literal(ExprNode):
    """NULL / int / float-as-Decimal / string literal (ref: ast ValueExpr).

    `pos` is the source byte offset of the masked lexer token this
    literal came from (-1: synthesized, not a maskable token; -2: an
    uncacheable multi-token/transformed shape) — the plan cache's literal
    SLOT ordinal derives from it (sql/plancache.py), matching the
    token-order normalization the statement digest uses. Excluded from
    ast_digest (Literal nodes mask whole)."""

    value: object  # None | int | Decimal-string tuple | str | bytes
    kind: str  # "null" | "int" | "float" | "decimal" | "str" | "hex" | "bool"
    pos: int = -1


@dataclass
class ParamMarker(ExprNode):
    index: int
    pos: int = -1  # source byte offset of the '?' token (plan-cache slot)


@dataclass
class ColumnName(ExprNode):
    name: str
    table: str = ""
    db: str = ""

    def __str__(self):
        parts = [p for p in (self.db, self.table, self.name) if p]
        return ".".join(parts)


@dataclass
class Star(ExprNode):
    table: str = ""  # t.* when set
    db: str = ""  # db.t.* when set


@dataclass
class BinaryOp(ExprNode):
    op: str  # normalized lowercase: plus/minus/mul/div/intdiv/mod/eq/ne/lt/le/gt/ge/nulleq/and/or/xor/bitand/bitor/bitxor/shiftleft/shiftright
    left: ExprNode
    right: ExprNode


@dataclass
class UnaryOp(ExprNode):
    op: str  # not / unaryminus / bitneg
    operand: ExprNode


@dataclass
class FuncCall(ExprNode):
    name: str  # lowercase
    args: list = field(default_factory=list)


@dataclass
class AggFunc(ExprNode):
    name: str  # count/sum/avg/min/max/group_concat/bit_and/bit_or/bit_xor/stddev/var_pop...
    args: list = field(default_factory=list)
    distinct: bool = False
    order_by: list = field(default_factory=list)  # GROUP_CONCAT(... ORDER BY ...)
    separator: Optional[str] = None  # GROUP_CONCAT(... SEPARATOR s)


@dataclass
class WindowFunc(ExprNode):
    """fn(args) OVER (PARTITION BY ... ORDER BY ...) (ref: ast.WindowFuncExpr).

    has_frame marks an explicit non-default ROWS/RANGE clause — the planner
    rejects those at lowering (default frames only on device)."""

    name: str
    args: list  # [ExprNode]
    partition_by: list = field(default_factory=list)  # [ExprNode]
    order_by: list = field(default_factory=list)  # [ByItem]
    has_frame: bool = False


@dataclass
class IsNull(ExprNode):
    expr: ExprNode
    negated: bool = False


@dataclass
class IsTruth(ExprNode):
    expr: ExprNode
    truth: bool  # IS TRUE / IS FALSE
    negated: bool = False


@dataclass
class Between(ExprNode):
    expr: ExprNode
    low: ExprNode
    high: ExprNode
    negated: bool = False


@dataclass
class InList(ExprNode):
    expr: ExprNode
    items: list
    negated: bool = False


@dataclass
class SemiJoinCond(ExprNode):
    """Planner-internal conjunct produced by subquery decorrelation (never
    emitted by the parser): row passes iff a matching row exists (anti:
    does not exist) in `table` on probe_exprs[i] = build_cols[i]
    (ref: the semi-join LogicalJoin the reference's decorrelation rules
    produce, pkg/planner/core/rule_decorrelate.go)."""

    table: str  # materialized/real table name holding the subquery rows
    probe_exprs: list  # [ExprNode] over the outer schema
    build_cols: list  # [str] column names in `table`
    anti: bool = False
    require_notnull_probe: bool = False  # NOT IN: NULL probe would be wrong


@dataclass
class InSubquery(ExprNode):
    expr: ExprNode
    subquery: "SelectStmt"
    negated: bool = False


@dataclass
class Exists(ExprNode):
    subquery: "SelectStmt"
    negated: bool = False


@dataclass
class SubqueryExpr(ExprNode):
    """Scalar subquery."""

    subquery: "SelectStmt"


@dataclass
class CompareSubquery(ExprNode):
    """expr op ANY/ALL (subquery)."""

    expr: ExprNode
    op: str
    subquery: "SelectStmt"
    all: bool


@dataclass
class Like(ExprNode):
    expr: ExprNode
    pattern: ExprNode
    escape: str = "\\"
    negated: bool = False


@dataclass
class Regexp(ExprNode):
    expr: ExprNode
    pattern: ExprNode
    negated: bool = False


@dataclass
class Case(ExprNode):
    operand: Optional[ExprNode]
    when_clauses: list  # [(cond, result)]
    else_clause: Optional[ExprNode]


@dataclass
class Cast(ExprNode):
    expr: ExprNode
    to_type: "TypeSpec"


@dataclass
class Interval(ExprNode):
    value: ExprNode
    unit: str  # day/month/year/hour/minute/second/...


@dataclass
class Default(ExprNode):
    column: str = ""


@dataclass
class Variable(ExprNode):
    name: str
    system: bool  # @@x vs @x
    scope: str = ""  # "global" | "session" | ""


@dataclass
class RowExpr(ExprNode):
    items: list


# ---------------------------------------------------------------- type spec


@dataclass
class TypeSpec:
    """Column type in DDL / CAST (ref: pkg/parser/types FieldType AST form)."""

    name: str  # normalized lowercase: int/bigint/varchar/decimal/date/datetime/...
    length: int = -1
    decimal: int = -1
    unsigned: bool = False
    zerofill: bool = False
    charset: str = ""
    collate: str = ""
    elems: tuple = ()  # enum/set elements


# ---------------------------------------------------------------- table refs


@dataclass
class TableName:
    name: str
    db: str = ""
    alias: str = ""
    index_hints: list = field(default_factory=list)


@dataclass
class SubqueryTable:
    subquery: "SelectStmt"
    alias: str


@dataclass
class Join:
    left: object
    right: object
    kind: str  # "inner" | "left" | "right" | "cross"
    on: Optional[ExprNode] = None
    using: list = field(default_factory=list)


# ---------------------------------------------------------------- SELECT


@dataclass
class SelectField:
    expr: ExprNode
    alias: str = ""
    # verbatim source text of the expression — MySQL titles unaliased
    # expression columns with the text as written (ref: the reference's
    # field name derivation in planner buildProjectionField)
    source: str = ""


@dataclass
class ByItem:
    expr: ExprNode
    desc: bool = False


@dataclass
class Limit:
    count: Optional[ExprNode]
    offset: Optional[ExprNode] = None


@dataclass
class CTE:
    """One WITH-clause entry (ref: ast.CommonTableExpression)."""

    name: str
    columns: list  # [str] optional column aliases
    subquery: "SelectStmt"
    recursive: bool = False


@dataclass
class SelectStmt:  # noqa: PLR0902
    fields: list  # [SelectField|Star]
    from_clause: object = None  # TableName | SubqueryTable | Join | None
    where: Optional[ExprNode] = None
    group_by: list = field(default_factory=list)  # [ByItem]
    having: Optional[ExprNode] = None
    order_by: list = field(default_factory=list)  # [ByItem]
    limit: Optional[Limit] = None
    distinct: bool = False
    for_update: bool = False
    ctes: list = field(default_factory=list)  # [CTE]
    hints: list = field(default_factory=list)  # [(name, [args])] from /*+ */


@dataclass
class SetOprStmt:
    """UNION / EXCEPT / INTERSECT chains (ref: ast.SetOprStmt)."""

    selects: list  # [SelectStmt]
    all_flags: list  # [bool] between consecutive selects
    order_by: list = field(default_factory=list)
    limit: Optional[Limit] = None
    ops: list = field(default_factory=list)  # "union"|"except"|"intersect" per boundary
    ctes: list = field(default_factory=list)  # [CTE]


# ---------------------------------------------------------------- DML


@dataclass
class Assignment:
    column: ColumnName
    expr: ExprNode


@dataclass
class InsertStmt:
    table: TableName
    columns: list  # [str]
    values: list  # [[ExprNode]]
    select: Optional[SelectStmt] = None
    on_duplicate: list = field(default_factory=list)  # [Assignment]
    replace: bool = False
    ignore: bool = False


@dataclass
class UpdateStmt:
    table: object  # TableName | Join
    assignments: list  # [Assignment]
    where: Optional[ExprNode] = None
    order_by: list = field(default_factory=list)
    limit: Optional[Limit] = None


@dataclass
class DeleteStmt:
    table: TableName
    where: Optional[ExprNode] = None
    order_by: list = field(default_factory=list)
    limit: Optional[Limit] = None
    multi_table: bool = False  # DELETE t1,t2 FROM ... — parsed, rejected at exec


@dataclass
class LoadDataStmt:
    path: str
    table: TableName
    fields_terminated: str = "\t"
    fields_enclosed: str = ""
    lines_terminated: str = "\n"
    ignore_lines: int = 0
    columns: list = field(default_factory=list)


# ---------------------------------------------------------------- DDL


@dataclass
class ColumnDef:
    name: str
    type: TypeSpec
    not_null: bool = False
    default: Optional[ExprNode] = None
    auto_increment: bool = False
    primary_key: bool = False
    unique: bool = False
    comment: str = ""
    on_update_now: bool = False
    generated: Optional[ExprNode] = None  # GENERATED ALWAYS AS (expr)
    generated_stored: bool = False  # STORED vs VIRTUAL
    check: Optional[ExprNode] = None  # column CHECK constraint


@dataclass
class IndexDef:
    name: str
    columns: list  # [(col_name, prefix_len)]
    unique: bool = False
    primary: bool = False


@dataclass
class ForeignKeyDef:
    name: str
    columns: list
    ref_table: TableName
    ref_columns: list
    on_delete: str = "restrict"  # restrict | cascade | set_null | no_action
    on_update: str = "restrict"


@dataclass
class CreateTableStmt:
    table: TableName
    columns: list  # [ColumnDef]
    indexes: list = field(default_factory=list)  # [IndexDef]
    foreign_keys: list = field(default_factory=list)
    if_not_exists: bool = False
    options: dict = field(default_factory=dict)  # engine/charset/auto_increment/comment
    like: Optional[TableName] = None
    select: Optional[SelectStmt] = None


@dataclass
class DropTableStmt:
    tables: list  # [TableName]
    if_exists: bool = False


@dataclass
class TruncateTableStmt:
    table: TableName


@dataclass
class CreateDatabaseStmt:
    name: str
    if_not_exists: bool = False


@dataclass
class DropDatabaseStmt:
    name: str
    if_exists: bool = False


@dataclass
class CreateIndexStmt:
    index_name: str
    table: TableName
    columns: list  # [(col, prefix_len)]
    unique: bool = False


@dataclass
class DropIndexStmt:
    index_name: str
    table: TableName


@dataclass
class AlterTableSpec:
    """One ALTER TABLE action."""

    action: str  # add_column/drop_column/add_index/drop_index/modify_column/change_column/rename/add_primary/rename_index
    column: Optional[ColumnDef] = None
    index: Optional[IndexDef] = None
    name: str = ""  # old col/index name, or new table name for rename
    new_name: str = ""
    position: str = ""  # "" | "first" | "after:<col>"
    options: dict = field(default_factory=dict)  # table/partition options
    default: Optional[ExprNode] = None  # SET DEFAULT value


@dataclass
class AlterTableStmt:
    table: TableName
    specs: list  # [AlterTableSpec]


@dataclass
class RenameTableStmt:
    pairs: list  # [(TableName, TableName)]


# ---------------------------------------------------------------- misc stmts


@dataclass
class SetStmt:
    assignments: list  # [(scope, name, ExprNode)] scope in {"session","global","user"}


@dataclass
class UseStmt:
    db: str


@dataclass
class ShowStmt:
    kind: str  # databases/tables/columns/create_table/index/variables/status/warnings/processlist/engines/collation/charset/stats_meta
    table: Optional[TableName] = None
    db: str = ""
    pattern: Optional[str] = None
    where: Optional[ExprNode] = None
    full: bool = False
    global_scope: bool = False


@dataclass
class ExplainStmt:
    target: object  # statement
    analyze: bool = False
    format: str = "row"


@dataclass
class AnalyzeTableStmt:
    tables: list  # [TableName]
    columns: list = field(default_factory=list)


@dataclass
class CreateUserStmt:
    users: list  # [(name, host, password)]
    if_not_exists: bool = False


@dataclass
class DropUserStmt:
    users: list  # [(name, host)]
    if_exists: bool = False


@dataclass
class GrantStmt:
    privs: list  # ["select", ...] or ["all"]
    db: str  # "*" = all
    table: str  # "*" = all
    users: list  # [(name, host)]


@dataclass
class RevokeStmt:
    privs: list
    db: str
    table: str
    users: list


@dataclass
class BeginStmt:
    pass


@dataclass
class CommitStmt:
    pass


@dataclass
class RollbackStmt:
    pass


@dataclass
class PrepareStmt:
    name: str
    sql: str


@dataclass
class ExecuteStmt:
    name: str
    using: list = field(default_factory=list)  # [@var names]


@dataclass
class DeallocateStmt:
    name: str


@dataclass
class AdminStmt:
    kind: str  # check_table / show_ddl / show_ddl_jobs / cancel_ddl_jobs / checksum_table
    tables: list = field(default_factory=list)
    job_ids: list = field(default_factory=list)


@dataclass
class FlashbackStmt:
    table: TableName
    new_name: str = ""


@dataclass
class KillStmt:
    conn_id: int
    query_only: bool = False


@dataclass
class BRIEStmt:
    """BACKUP/RESTORE SQL (ref: br glue pkg/executor/brie.go), with
    the PITR forms: `BACKUP LOG TO ...` / `STOP BACKUP LOG TO ...`
    attach/detach a durable log backup (kind "backup_log" /
    "stop_backup_log"), and `RESTORE FROM ... UNTIL TS = n` replays the
    log to an exact ts (`until_ts` set)."""

    kind: str  # "backup" | "restore" | "backup_log" | "stop_backup_log"
    storage: str
    tables: list = field(default_factory=list)  # empty = full
    until_ts: int | None = None  # RESTORE ... UNTIL TS = n


@dataclass
class TraceStmt:
    target: object  # statement
    format: str = "row"  # 'row' | 'json' (ref: parser.y TraceStmt FORMAT)


@dataclass
class ChangefeedStmt:
    """CREATE/PAUSE/RESUME/DROP CHANGEFEED (ref: TiCDC's `cdc cli
    changefeed create --sink-uri=... --start-ts=...`, SQL-ified the way
    the reference SQL-ifies BR as BACKUP/RESTORE)."""

    action: str  # create | pause | resume | drop
    name: str
    sink_uri: str = ""
    tables: list = field(default_factory=list)  # [TableName]; empty = all
    options: dict = field(default_factory=dict)  # WITH k = v (start_ts, ...)


@dataclass
class CollateExpr(ExprNode):
    """expr COLLATE collation_name (ref: parser.y SimpleExpr collate)."""

    expr: ExprNode
    collation: str


@dataclass
class CreateViewStmt:
    """(ref: parser.y CreateViewStmt)."""

    name: "TableName"
    columns: list
    select: object
    or_replace: bool = False
    source: str = ""  # verbatim SELECT text (persisted as the view body)


@dataclass
class DropViewStmt:
    names: list
    if_exists: bool = False


@dataclass
class CreateSequenceStmt:
    name: "TableName"
    if_not_exists: bool = False
    options: dict = field(default_factory=dict)


@dataclass
class DropSequenceStmt:
    names: list
    if_exists: bool = False


@dataclass
class AlterUserStmt:
    """(ref: parser.y AlterUserStmt; options recorded, not all enforced)."""

    users: list
    if_exists: bool = False
    options: dict = field(default_factory=dict)


@dataclass
class ImportIntoStmt:
    """(ref: parser.y ImportIntoStmt — the disttask bulk-import entry)."""

    table: "TableName"
    columns: list
    path: str
    options: dict = field(default_factory=dict)


@dataclass
class BatchStmt:
    """BATCH [ON col] LIMIT n <dml> (ref: parser.y NonTransactionalDMLStmt)."""

    column: str
    limit: int
    inner: object


@dataclass
class SplitTableStmt:
    """SPLIT TABLE ... (ref: parser.y SplitRegionStmt)."""

    table: "TableName"
    index: str = ""
    between: tuple | None = None  # (lo exprs, hi exprs, regions)
    by_points: list = field(default_factory=list)  # [[exprs], ...]


@dataclass
class LoadStatsStmt:
    path: str


@dataclass
class BindingStmt:
    """CREATE/DROP [GLOBAL|SESSION] BINDING (ref: pkg/bindinfo)."""

    action: str  # create | drop
    scope: str  # global | session
    target: object  # bound statement AST
    hinted: object = None  # USING statement AST (create only)
    target_sql: str = ""  # display text (SHOW BINDINGS)
    hinted_sql: str = ""


@dataclass
class SavepointStmt:
    """SAVEPOINT / ROLLBACK TO [SAVEPOINT] / RELEASE SAVEPOINT."""

    action: str  # set | rollback | release
    name: str
