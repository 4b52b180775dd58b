"""True-positive fixture for the port's `torch-purity` pass: module-level
tensors (made at import, their device and dtype fixed then) and
process-wide torch toggles. NEVER imported — scanned as text by
tests/test_torch_vet.py."""

import torch

BAD_CONST = torch.zeros(4)  # VIOLATION: a tensor made at import
BAD_DERIVED = BAD_CONST + torch.arange(4)  # VIOLATION: derived from one

torch.set_default_dtype(torch.float64)  # VIOLATION: process-wide toggle


def configure():
    torch.backends.cuda.matmul.allow_tf32 = True  # VIOLATION: a backend flag, process-wide
