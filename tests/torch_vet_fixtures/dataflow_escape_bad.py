"""dataflow-error-escape true positives: a bare RuntimeError escaping
the request path, and a typed region error crossing the session boundary
with no SQLError mapping."""


class RegionTimeoutError(RuntimeError):
    """Typed region error nobody maps to a MySQL code."""


def select(store, req):  # vet: request-path-root
    if store.busy:
        raise RuntimeError("store busy")  # bare: dispatch cannot classify it
    raise RegionTimeoutError("region 7 timed out")


class Session:
    def execute(self, sql):  # vet: session-boundary
        return select(self.store, sql)
