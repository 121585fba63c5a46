"""Gadgets: in-circuit building blocks over `ir.CircuitBuilder`.

Host copy of `plonky2_tpu/gadgets/`; the SMT and u32 gadgets are ported.
"""

from . import smt, u32  # noqa: F401
