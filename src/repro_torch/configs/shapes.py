"""The four assigned input shapes (LM transformer: seq_len x global_batch),
as ``repro.configs.shapes`` declares them.

decode_* / long_* lower ``serve_step`` (one new token against a KV cache
of seq_len), NOT ``train_step``.  long_500k requires sub-quadratic
attention — skipped for pure full-attention archs (docs/architecture.md
§"Model families and input shapes").  ``SUBQUADRATIC_ARCHS`` names the
reference's recurrent and hybrid families, which the port does not
serve yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# archs whose attention is strictly full/quadratic skip long_500k
SUBQUADRATIC_ARCHS = ("hymba-1.5b", "rwkv6-1.6b")


def long_context_ok(arch: str) -> bool:
    return arch in SUBQUADRATIC_ARCHS
