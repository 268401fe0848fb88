"""Statement data structures: formal variables and linear combinations, R1CS
constraint systems and their compiled form, and the QRP containers."""

from .variable import Variable, LinearTerm, LinearCombination, ONE_INDEX  # noqa: F401
from .r1cs import R1CSConstraint, R1CSConstraintSystem, CompiledR1CS  # noqa: F401
from .qrp import QRPInstance, QRPInstanceEvaluation, QRPWitness  # noqa: F401
