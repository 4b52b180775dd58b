"""Where the SQL session (and the PD tick) meets a subsystem the port does
not have yet.

Each function stands at a call the reference session makes into a package
that is not ported, and answers as the reference does when that subsystem
declines or has nothing attached. None of them succeeds silently where the
reference would do work:

  columnar_would_serve  False: there is no columnar replica, so the row
                        store serves every plan (and the MPP tier's probe
                        scan, mpp/dispatch.py)
  pitr_tick             the PD tick's pd.pitr phase: nothing, as on a
                        reference store with no log backup attached
  columnar_views, changefeed_views, log_backup_views
                        the rows of SHOW COLUMNAR TABLES / CHANGEFEEDS /
                        BACKUP LOGS: none, as on a reference store with no
                        replica, feed or log backup attached
  not_ported            the error for CREATE / PAUSE / RESUME / DROP
                        CHANGEFEED, BACKUP, RESTORE, BACKUP LOG and ALTER
                        TABLE ... SET COLUMNAR REPLICA: SQLError with MySQL
                        code 1105 (ER_UNKNOWN_ERROR)
"""

from __future__ import annotations


def columnar_would_serve(store, dag, ranges, engines) -> bool:
    return False


def pitr_tick(store) -> None:
    return None


def columnar_views(store) -> list:
    return []


def changefeed_views(store) -> list:
    return []


def log_backup_views(store) -> list:
    return []


def not_ported(what: str):
    """The SQLError a statement of a subsystem that is not ported raises."""
    from .session import SQLError

    return SQLError(f"{what} is not ported", code=1105)
