"""Testing utilities: deterministic fault injection for the serving engine
(``mxnet_tpu_torch.testing.faults``)."""
from __future__ import annotations

__all__ = ["faults"]
