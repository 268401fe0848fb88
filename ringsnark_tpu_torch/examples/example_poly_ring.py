"""End-to-end demo over the polynomial ring R_q = Z_q[X]/(X^N+1) (the
repository's ``examples/example_poly_ring.py``; the reference's
``examples/example_SEAL.cpp``).

The toy circuit x5 = x2*x3; x4 = (x0+x1)*x5 (x5 private), proved and
verified with Rinocchio and ringGroth16.  Defaults to the reference
example's shape (N=4096, L=3 outer primes; inner N'=8192, L'=4,
`example_SEAL.cpp:38-119`); ``--small`` takes N=256, N'=512.

    python -m ringsnark_tpu_torch.examples.example_poly_ring [--small] [--N 4096]
        [--n-inner 8192] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..scripts.common import device_for
from .common import prove_both

__all__ = ["main", "make_params", "run"]


def make_params(N: int, n_inner: int, L: int = 3, L_inner: int = 4, device: str = "cuda"):
    from ..encoding import EncodingContext
    from ..encoding.context import default_inner_primes
    from ..rings.context import default_context
    from ..snark.api import SnarkParams

    ring = default_context(L=L, N=N, order=max(1 << 12, 2 * n_inner, 4 * N), device=device)
    inner = default_inner_primes(n_inner, ring.primes, count=L_inner)
    print(f"[PARAM] outer: N={N}, L={L} x ~31-bit primes {ring.primes}")
    print(f"[PARAM] inner: N'={n_inner}, L'={len(inner)} primes {inner}")
    return SnarkParams(ring=ring, enc=EncodingContext(ring=ring, n_inner=n_inner,
                                                      inner_primes=inner))


def run(params, seed: int = 0) -> dict:
    from ..models import build_toy_circuit

    rng = np.random.default_rng(seed)
    pb = build_toy_circuit(params.ring, rng)
    print(f"#Inputs\t{pb.num_inputs()}")
    print(f"#Variables\t{pb.num_variables()}")
    print(f"#Constraints\t{pb.num_constraints()}")
    if not pb.is_satisfied():
        raise RuntimeError("the toy circuit's witness does not satisfy it")
    print("R1CS satisfied: True")
    return {"constraints": pb.num_constraints(), "systems": prove_both(pb, params, rng, seed)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--N", type=int, default=4096, help="outer degree")
    ap.add_argument("--n-inner", type=int, default=8192)
    ap.add_argument("--small", action="store_true", help="N=256, N'=512")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain twins)")
    args = ap.parse_args(argv)
    if args.small:
        args.N, args.n_inner = 256, 512
    return run(make_params(args.N, args.n_inner, device=device_for(args.cpu)))


if __name__ == "__main__":
    main()
