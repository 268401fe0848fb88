"""Proof systems: ringGroth16 over rings, resident and seeded CRS (Rinocchio
is not ported yet)."""

from .api import KeyPair, SnarkParams  # noqa: F401
from . import groth16, seeded  # noqa: F401
