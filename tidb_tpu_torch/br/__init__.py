"""Point-in-time recovery (ref: br/pkg/stream + br/pkg/task
PiTR): log backup riding the CDC stream as a raw changefeed, replay-to-ts
RESTORE over the latest full backup, and the pd.pitr tick phase.

Copy of `tidb_tpu/br/` for the PyTorch port (it imports nothing of
tidb_tpu)."""

from .pitr import (
    LogBackup,
    LogBackupSink,
    LogGapError,
    ReplayInterrupted,
    log_backup_views,
    pitr_tick,
    restore_until,
    start_log_backup,
    stop_log_backup,
)

__all__ = [
    "LogBackup", "LogBackupSink", "LogGapError", "ReplayInterrupted",
    "log_backup_views", "pitr_tick", "restore_until", "start_log_backup",
    "stop_log_backup",
]
