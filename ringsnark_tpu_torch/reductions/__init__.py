"""Reductions between relations (R1CS -> QRP)."""

from .r1cs_to_qrp import (  # noqa: F401
    r1cs_to_qrp_instance_map,
    r1cs_to_qrp_instance_map_with_evaluation,
    r1cs_to_qrp_witness_map,
    r1cs_to_qrp_witness_map_generic,
    prover_witness_map_chunked,
)
