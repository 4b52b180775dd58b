"""dataflow-backoff true positives: an unbounded retry loop that never
consults a Backoffer budget, and a raw time.sleep on the request path
(unsliced: KILL QUERY waits out the whole nap; unclamped: it can outlive
the statement deadline)."""

import time


def select(store, req):  # vet: request-path-root
    while True:
        resp = store.coprocessor(req)
        if resp.region_error is not None:
            time.sleep(0.05)
            continue
        return resp
