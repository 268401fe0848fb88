"""The repository's examples on the port, each the counterpart of the file of
the same name in ``examples/``: the toy circuit over Z_q replicated per slot
(``example_int_ring``) and over R_q (``example_poly_ring``), the vFHE
plaintext check (``example_plaintext_check``), and the primitives' timings
(``microbench``).  Each proves with both systems where it proves, asserts
that the verifier accepts, and runs on the card unless given ``--cpu``:

    python -m ringsnark_tpu_torch.examples.example_poly_ring [--small] [--cpu]

``main(argv) -> dict`` returns what the example printed, with its proofs
and verification bits.
"""
