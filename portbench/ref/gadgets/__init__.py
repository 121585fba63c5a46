"""Gadgets: in-circuit building blocks over `ir.CircuitBuilder`.

Host copy of `plonky2_tpu/gadgets/`; the SMT, u32, biguint, nonnative,
secp256k1 curve, ECDSA and Keccak-256 gadgets are ported.  Importing the
package attaches their builder methods.
"""

import inspect


def attach(namespace: dict) -> None:
    """Attach to `CircuitBuilder` every function defined in the module of
    `namespace` (its `globals()`) whose first parameter is `self`."""
    from ..ir.builder import CircuitBuilder

    module = namespace["__name__"]
    for name, fn in list(namespace.items()):
        if (inspect.isfunction(fn) and fn.__module__ == module
                and next(iter(inspect.signature(fn).parameters), None) == "self"):
            setattr(CircuitBuilder, name, fn)


from . import smt, u32  # noqa: E402,F401
from . import biguint, nonnative, curve, ecdsa, keccak  # noqa: E402,F401
