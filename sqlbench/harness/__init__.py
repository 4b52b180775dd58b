"""The benchmark's own machinery: specs, deployment, traffic, the closed
loop, the trace reduction and the answer check. It drives the port
(`tidb_tpu_torch`) only through its public surface."""
