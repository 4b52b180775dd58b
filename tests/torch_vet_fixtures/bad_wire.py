"""True-positive fixture for the port's `wire-parity` pass (the file name
ends in `wire.py` so the pass picks it up): an encoder with no decoder, a
pair whose fields don't line up, and a fragment-frame pair whose
sub-structures don't mirror. NEVER imported — scanned as text by
tests/test_torch_vet.py."""


def encode_orphan(w, req):  # VIOLATION: no decode_orphan anywhere
    w.i64(req.id)


def encode_lossy(w, resp):
    w.i64(resp.rows)
    w.f64(resp.elapsed)  # VIOLATION: the decoder never reads an f64 back


def decode_lossy(r):
    return r.i64()


def w_exchange_sender(w, s):
    w.u8(s.kind)


def r_exchange_sender(r):
    return r.u8()


def encode_fragment_plan(w, fplan):
    w_exchange_sender(w, fplan.sender)  # VIOLATION: the decoder reads no sender back
    w.i32(fplan.n)


def decode_fragment_plan(r):
    return r.i32()
