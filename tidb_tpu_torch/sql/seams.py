"""Where the SQL session (and the PD tick) meets a subsystem the port does
not have yet: BR and log backup (tidb_tpu/br/, tools/br.py).

Each function stands at a call the reference session makes into that
package, and answers as the reference does when it has nothing attached.
None of them succeeds silently where the reference would do work:

  pitr_tick         the PD tick's pd.pitr phase as on a reference store
                    with no log backup attached: it only trims the schema
                    journal below every live changefeed's checkpoint
  log_backup_views  the rows of SHOW BACKUP LOGS: none, as on a reference
                    store with no log backup attached
  not_ported        the error for BACKUP, RESTORE and BACKUP LOG: SQLError
                    with MySQL code 1105 (ER_UNKNOWN_ERROR)
"""

from __future__ import annotations


def pitr_tick(store) -> None:
    """The reference's br/pitr.py pitr_tick with no log backup to refresh:
    a feed only ever injects (checkpoint, candidate] from the journal, and
    feeds born later snapshot the live catalog, so nothing can still need
    the trimmed window."""
    hub = getattr(store, "cdc", None)
    if hub is None:
        return None  # a bare store without the CDC surface
    feeds = hub.feeds()
    if feeds:
        store.schema_journal.trim(min(f.view(store)["checkpoint_ts"] for f in feeds))
    return None


def log_backup_views(store) -> list:
    return []


def not_ported(what: str):
    """The SQLError a statement of a subsystem that is not ported raises."""
    from .session import SQLError

    return SQLError(f"{what} is not ported", code=1105)
