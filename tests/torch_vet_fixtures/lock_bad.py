"""True-positive fixture for the port's `lock-discipline` pass: a
`# guarded_by:`-annotated attribute read and written off-lock. NEVER
imported — scanned as text by tests/test_torch_vet.py."""

import threading


class LeakyCounter:
    def __init__(self):
        self._mu = threading.Lock()
        self.hits = 0  # guarded_by: _mu

    def bump(self):
        with self._mu:
            self.hits += 1

    def bump_racy(self):
        self.hits += 1  # VIOLATION: write outside the lock

    def peek_racy(self) -> int:
        return self.hits  # VIOLATION: read outside the lock

    def helper(self):  # requires: _mu
        self.hits = 0  # ok: declared to run with _mu held
