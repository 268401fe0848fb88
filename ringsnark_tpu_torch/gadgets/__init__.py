"""Circuit frontend: protoboard + pb_variable DSL + gadget library.

Port of ``ringsnark_tpu/gadgets`` (the reference's `gadgetlib/`), plus
concrete gadgets (the reference ships only the abstract `gadget` base,
`gadget.hpp:15-23`).
"""

from .protoboard import Protoboard  # noqa: F401
from .pb_variable import (  # noqa: F401
    PBVariable,
    PBVariableArray,
    PBLinearCombination,
    PBLinearCombinationArray,
    pb_sum,
    pb_packing_sum,
    pb_coeff_sum,
)
from .gadget import Gadget  # noqa: F401
from .basic_gadgets import BitDecompositionGadget, InnerProductGadget  # noqa: F401
