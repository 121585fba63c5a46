"""Gadgets: in-circuit building blocks over `ir.CircuitBuilder`.

Host copy of `plonky2_tpu/gadgets/`; only the SMT gadgets are ported.
"""

from . import smt  # noqa: F401
