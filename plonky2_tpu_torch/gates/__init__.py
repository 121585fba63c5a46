from .base import BatchAlg, EvalVars, Gate  # noqa: F401
from .arithmetic import ArithmeticGate  # noqa: F401
from .simple import ConstantGate, NoopGate, PublicInputGate  # noqa: F401
from .poseidon_gate import PoseidonGate  # noqa: F401
from .base_sum import BaseSumGate  # noqa: F401
