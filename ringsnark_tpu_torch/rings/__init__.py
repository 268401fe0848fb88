"""Ring backends: R_q = Z_q[X]/(X^N+1) in slot form, and the Z_q integer ring
(and `oracle`, an exact Python-integer Z_q for the generic algorithms)."""

from .context import RingContext, default_context  # noqa: F401
from .elem import RingElem  # noqa: F401
