"""Abstract gadget base (port of ``ringsnark_tpu/gadgets/gadget.py``; reference
`gadgetlib/gadget.hpp:15-23`)."""

from __future__ import annotations

from .protoboard import Protoboard

__all__ = ["Gadget"]


class Gadget:
    """A reusable circuit fragment bound to a protoboard.

    Subclasses implement `generate_r1cs_constraints()` (emit constraints) and
    `generate_r1cs_witness()` (fill in values).  The reference ships only this
    base class; concrete gadgets live in `basic_gadgets.py`.
    """

    def __init__(self, pb: Protoboard, annotation_prefix: str = ""):
        self.pb = pb
        self.annotation_prefix = annotation_prefix

    def generate_r1cs_constraints(self):
        raise NotImplementedError

    def generate_r1cs_witness(self):
        raise NotImplementedError
