"""Privilege management (ref: pkg/privilege/privileges — MySQL-compatible
user records with global/db/table scoped privilege sets, cached in memory
exactly like the reference's MySQLPrivilege cache of the mysql.* tables).

The store lives on the shared Catalog (domain-level in the reference);
every session carries the authenticated user and execute_stmt checks the
statement's required privilege against it. The built-in 'root' user is a
superuser. Passwords are stored plain here and handed to the wire server,
which performs the mysql_native_password scramble check.

Copy of `tidb_tpu/sql/privilege.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

PRIVS = frozenset({
    "select", "insert", "update", "delete", "create", "drop", "alter",
    "index", "all",
})


class PrivilegeError(ValueError):
    pass


@dataclass
class UserRecord:
    name: str
    host: str
    password: str = ""
    global_privs: set = field(default_factory=set)
    db_privs: dict = field(default_factory=dict)  # db -> set
    table_privs: dict = field(default_factory=dict)  # (db, table) -> set


class PrivilegeStore:
    def __init__(self):
        self._users: dict[tuple, UserRecord] = {}  # guarded_by: _lock
        self._lock = threading.Lock()
        # bootstrap superuser (ref: session/bootstrap.go root creation)
        self._users[("root", "%")] = UserRecord("root", "%", "", {"all"})

    # ------------------------------------------------------------------
    def create_user(self, name: str, host: str, password: str, if_not_exists: bool):
        with self._lock:
            key = (name.lower(), host)
            if key in self._users:
                if if_not_exists:
                    return
                raise PrivilegeError(f"user {name!r}@{host!r} already exists")
            self._users[key] = UserRecord(name.lower(), host, password or "")

    def drop_user(self, name: str, host: str, if_exists: bool):
        with self._lock:
            key = (name.lower(), host)
            if key not in self._users:
                if if_exists:
                    return
                raise PrivilegeError(f"user {name!r}@{host!r} does not exist")
            if key == ("root", "%"):
                raise PrivilegeError("cannot drop the bootstrap superuser")
            del self._users[key]

    def _record(self, name: str, host: str = "%") -> UserRecord:  # requires: _lock
        u = self._users.get((name.lower(), host)) or self._users.get((name.lower(), "%"))
        if u is None:
            raise PrivilegeError(f"user {name!r} does not exist")
        return u

    def grant(self, privs: list, db: str, table: str, name: str, host: str):
        with self._lock:
            u = self._record(name, host)
            pset = {p.lower() for p in privs}
            bad = pset - PRIVS
            if bad:
                raise PrivilegeError(f"unknown privilege {sorted(bad)[0]!r}")
            if db == "*" and table == "*":
                u.global_privs |= pset
            elif table == "*":
                u.db_privs.setdefault(db.lower(), set()).update(pset)
            else:
                u.table_privs.setdefault((db.lower(), table.lower()), set()).update(pset)

    def revoke(self, privs: list, db: str, table: str, name: str, host: str):
        with self._lock:
            u = self._record(name, host)
            pset = {p.lower() for p in privs}
            bad = pset - PRIVS
            if bad:
                raise PrivilegeError(f"unknown privilege {sorted(bad)[0]!r}")
            if db == "*" and table == "*":
                u.global_privs -= pset
            elif table == "*":
                u.db_privs.get(db.lower(), set()).difference_update(pset)
            else:
                u.table_privs.get((db.lower(), table.lower()), set()).difference_update(pset)

    # ------------------------------------------------------------------
    def check(self, user: str, priv: str, table: str = "*", db: str = "*") -> bool:
        """(ref: privileges.RequestVerification): global, then db, then
        table scope; 'all' matches any privilege. db defaults to the single
        implicit database, so db-qualified grants match unqualified use."""
        with self._lock:
            return self._check_locked(user, priv, table, db)

    def _check_locked(self, user: str, priv: str, table: str, db: str) -> bool:
        try:
            u = self._record(user)
        except PrivilegeError:
            return False
        want = {priv.lower(), "all"}
        if u.global_privs & want:
            return True
        if u.db_privs.get(db.lower(), set()) & want:
            return True
        if u.table_privs.get((db.lower(), table.lower()), set()) & want:
            return True
        # db-scope grant covers its tables; table grants under "*" db match
        if table != "*" and u.table_privs.get(("*", table.lower()), set()) & want:
            return True
        return False

    def is_super(self, user: str) -> bool:
        with self._lock:
            try:
                return "all" in self._record(user).global_privs
            except PrivilegeError:
                return False

    def password_of(self, user: str) -> bytes | None:
        """For the wire server's scramble check; None = unknown user."""
        with self._lock:
            try:
                return self._record(user).password.encode()
            except PrivilegeError:
                return None

    def users(self) -> list:
        with self._lock:
            return sorted(self._users)
