"""Proof systems: ringGroth16 over rings (resident, seeded and streamed CRS)
and Rinocchio (resident and streamed CRS), the tensor cores of both provers
(`pipeline`), and soundness amplification by repetition."""

from .api import KeyPair, SnarkParams  # noqa: F401
from . import groth16, seeded, rinocchio, streamed, amplify  # noqa: F401
