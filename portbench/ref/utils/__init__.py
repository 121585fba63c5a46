from .device import DEFAULT_DEVICE, resolve_device  # noqa: F401
from .timing import (TimingTree, last_tree, profiling_disable,  # noqa: F401
                     profiling_enable, timed_span)
