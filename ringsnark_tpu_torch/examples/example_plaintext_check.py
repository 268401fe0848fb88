"""vFHE plaintext-check demo (bit decomposition) with both proof systems
(the repository's ``examples/example_plaintext_check.py``; the reference's
``examples/example_plaintext_check_SEAL.cpp``).  The parameters are
``example_poly_ring.make_params``'s (L=3, L'=4).

    python -m ringsnark_tpu_torch.examples.example_plaintext_check [--N 256] [--logT 16]
        [--n-inner 512] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..scripts.common import device_for
from .common import prove_both
from .example_poly_ring import make_params

__all__ = ["main"]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--N", type=int, default=256)
    ap.add_argument("--logT", type=int, default=16)
    ap.add_argument("--n-inner", type=int, default=512)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain twins)")
    args = ap.parse_args(argv)

    from ..models import build_plaintext_check

    params = make_params(args.N, args.n_inner, device=device_for(args.cpu))
    rng = np.random.default_rng(0)
    pb = build_plaintext_check(params.ring, rng, log_t=args.logT)
    print(f"#Constraints\t{pb.num_constraints()}")
    if not pb.is_satisfied():
        raise RuntimeError("the plaintext check's witness does not satisfy it")
    print("R1CS satisfied: True")
    return {"constraints": pb.num_constraints(), "systems": prove_both(pb, params, rng, 0)}


if __name__ == "__main__":
    main()
