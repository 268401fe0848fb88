"""End-to-end demo over the integer ring Z_q, slot-replicated (the
repository's ``examples/example_int_ring.py``; the reference's
``examples/example_SEAL_int.cpp``).

The toy circuit replicated per slot (`replicate` scalar copies) over Z_q
with L=3 outer primes and N'=512, L'=4 inner primes, proved and verified
with Rinocchio and ringGroth16.

    python -m ringsnark_tpu_torch.examples.example_int_ring [--replicate 16] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..scripts.common import device_for
from .common import prove_both

__all__ = ["main", "make_params"]


def make_params(n_inner: int, device: str):
    from ..encoding import EncodingContext
    from ..encoding.context import default_inner_primes
    from ..rings.context import default_context
    from ..snark.api import SnarkParams

    ring = default_context(L=3, N=1, order=max(1 << 12, 2 * n_inner), device=device)
    return SnarkParams(ring=ring, enc=EncodingContext(
        ring=ring, n_inner=n_inner, inner_primes=default_inner_primes(n_inner, ring.primes, 4)))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--replicate", type=int, default=16)
    ap.add_argument("--n-inner", type=int, default=512)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain twins)")
    args = ap.parse_args(argv)

    from ..models import build_toy_circuit

    params = make_params(args.n_inner, device_for(args.cpu))
    rng = np.random.default_rng(0)
    pb = build_toy_circuit(params.ring, rng, replicate=args.replicate)
    print(f"#Inputs\t{pb.num_inputs()}")
    print(f"#Variables\t{pb.num_variables()}")
    print(f"#Constraints\t{pb.num_constraints()}")
    if not pb.is_satisfied():
        raise RuntimeError("the toy circuit's witness does not satisfy it")
    print("R1CS satisfied: True")
    return {"constraints": pb.num_constraints(), "systems": prove_both(pb, params, rng, 0)}


if __name__ == "__main__":
    main()
