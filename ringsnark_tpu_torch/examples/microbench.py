"""Primitive timings on the card (the repository's ``examples/microbench.py``;
the reference's ``microbench.cpp``).

NTT, scalar x ring, ring + ring, ring x ring, encode+encrypt of one element
and decrypt+decode, each a [TIME] line, and the analytic Rinocchio proof
size (`microbench.cpp:200-211`).  Times are per call, the mean of a run of
calls between two CUDA events after a warm-up (the host clock with
``--cpu``).

    python -m ringsnark_tpu_torch.examples.microbench [--N 8192] [--L 6]
        [--n-inner 8192] [--L-inner 4] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..scripts.common import card, device_for, event_seconds

__all__ = ["main"]

SEC_PARAM = 128  # microbench.cpp:20-24
NOISE_BITS = 45  # LMSS21 noise-flooding estimate (carried for parity)


def _time(fn, device: str, iters: int = 10) -> float:
    fn()  # warm
    return event_seconds(lambda: [fn() for _ in range(iters)], device) / iters


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--N", type=int, default=8192)
    ap.add_argument("--L", type=int, default=6)
    # the JAX script's 2048 is below N=8192, which no EncodingContext takes
    ap.add_argument("--n-inner", type=int, default=8192)
    ap.add_argument("--L-inner", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain twins)")
    args = ap.parse_args(argv)

    from ..encoding import EncodingContext, decode, encode, keygen
    from ..encoding.context import default_inner_primes
    from ..ops import ntt as nttm
    from ..rings.context import default_context
    from ..rings.elem import RingElem
    from ..utils import prng
    from ..utils.profiling import ntt_roofline

    device = device_for(args.cpu)
    N, L = args.N, args.L
    ring = default_context(L=L, N=N, order=max(1 << 15, 4 * N), device=device)
    rng = np.random.default_rng(0)
    a = RingElem.random_element(ring, rng)
    b = RingElem.random_element(ring, rng)
    s = RingElem.scalar(ring, 123456789)
    out = {"N": N, "L": L, "n_inner": args.n_inner, "L_inner": args.L_inner, "card": card(device)}

    out["ntt_s"] = _time(lambda: nttm.negacyclic_ntt_rev(a.res, ring.ntt_plan), device)
    print(f"[TIME] NTT        {out['ntt_s'] * 1e6:10.1f} us   (N={N}, {L} limbs)")
    rf = ntt_roofline(N, L, 1, out["ntt_s"], device)
    print(f"       roofline: {rf['int_ops_per_s'] / 1e9:.1f} Gint-ops/s, "
          f"{rf['achieved_GBps']:.1f} GB/s, {100 * rf['share_of_floor']:.1f} % of the copy floor")
    for label, key, fn in (("A x R", "scalar_mul_s", lambda: s * a),
                           ("R + R", "add_s", lambda: a + b),
                           ("R x R", "mul_s", lambda: a * b)):
        out[key] = _time(fn, device)
        print(f"[TIME] {label}      {out[key] * 1e6:10.1f} us")

    ectx = EncodingContext(ring=ring, n_inner=args.n_inner,
                           inner_primes=default_inner_primes(args.n_inner, ring.primes, args.L_inner))
    _, sk = keygen(ectx, rng)
    batch = RingElem.stack([a])
    key = prng.key(0)
    out["enc_s"] = _time(lambda: encode(ectx, sk, batch, key), device, iters=5)
    print(f"[TIME] 1 Enc      {out['enc_s'] * 1e6:10.1f} us")
    e = encode(ectx, sk, batch, key)
    out["dec_s"] = _time(lambda: decode(ectx, sk, e[0]), device, iters=3)
    if decode(ectx, sk, e[0]) != a:
        raise RuntimeError("decode(encode(a)) != a")
    print(f"[TIME] 1 Dec      {out['dec_s'] * 1e6:10.1f} us")

    # analytic 9-element Rinocchio proof size (microbench.cpp:207-210)
    out["rinocchio_proof_bits"] = 9 * 2 * L * args.L_inner * args.n_inner * 31
    print(f"[SIZE] Rinocchio proof (analytic): {out['rinocchio_proof_bits']} bits "
          f"= {out['rinocchio_proof_bits'] / 8 / 1024:.1f} KiB")
    return out


if __name__ == "__main__":
    main()
