"""Ecosystem tools the SQL session calls (copies of the JAX package's
tidb_tpu/tools/):

  dump.py       logical export to CSV/SQL at one consistent snapshot;
                SHOW CREATE TABLE uses its `_type_sql`
  lightning.py  bulk import (LOAD DATA) writing KV directly with a
                resumable checkpoint file
  br.py         physical backup/restore of the KV snapshot + schema with
                per-segment checksums and resume
"""

from .br import backup, restore
from .dump import dump_all, dump_table
from .lightning import load_data

__all__ = ["backup", "restore", "dump_all", "dump_table", "load_data"]
