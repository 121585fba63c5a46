from .base import BatchAlg, EvalVars, ExtAlg, Gate  # noqa: F401
from .arithmetic import ArithmeticGate  # noqa: F401
from .simple import ConstantGate, NoopGate, PublicInputGate  # noqa: F401
from .poseidon_gate import PoseidonGate  # noqa: F401
from .base_sum import BaseSumGate  # noqa: F401
from .u32_arithmetic import (U32AddManyGate, U32ArithmeticGate,  # noqa: F401
                             U32RangeCheckGate)
from .comparison import ComparisonGate, U32SubtractionGate  # noqa: F401
from .random_access import RandomAccessGate  # noqa: F401
from .u32_interleave import (U32InterleaveGate,  # noqa: F401
                             UninterleaveToB32Gate, UninterleaveToU32Gate)
