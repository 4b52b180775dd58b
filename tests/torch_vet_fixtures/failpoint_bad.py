"""True-positive fixture for the port's `failpoints` pass: arms a name no
eval/is_armed/peek site under tidb_tpu_torch/ defines — it could never
fire. NEVER imported — scanned as text (its directory's name holds
`vet_fixtures`, so neither package's live failpoints run reads it)."""

from tidb_tpu_torch.util import failpoint

failpoint.enable("vetfix/undefined-name")
