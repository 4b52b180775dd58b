"""dataflow-snapshot true positives: MVCC reads on a request path that
bypass the statement snapshot — a latest-version oracle read, a constant
ts, and a ts that never flowed from the request's start_ts."""


class MemKV:
    def get(self, key, ts):
        return None

    def scan(self, start, end, ts):
        return iter(())

    def max_ts(self):
        return 1 << 62


class Store:
    def __init__(self):
        self.kv = MemKV()
        self.wall_clock = 77

    def coprocessor(self, req):  # vet: request-path-root
        # BAD: reads whatever committed last, not the snapshot
        latest = self.kv.get(b"k", self.kv.max_ts())
        # BAD: constant ts — sees a frozen arbitrary cut
        pinned = list(self.kv.scan(b"a", b"z", 12345))
        # BAD: ts from unrelated state, no REQ/TS fact reaches it
        drifted = self.kv.get(b"k", self.wall_clock)
        # GOOD: flows the request's start_ts
        seen = self.kv.get(b"k", req.start_ts)
        return latest, pinned, drifted, seen

    def helper_scan(self, start_ts):
        # GOOD: start_ts arrives from the root through the call below
        return list(self.kv.scan(b"a", b"z", start_ts))

    def coprocessor_paged(self, req):  # vet: request-path-root
        return self.helper_scan(req.start_ts)
