"""The seeded encode's sections, timed apart (the repository's
``bench_encode_profile.py``).

For `--rows` CRS rows of the Z_q ring (L=1) in slabs of `--slab`, at inner
N' and L' primes:

* a_only: the uniform c1 of every slab (``bgv._sample_uniform`` from the
  slab's key, as the seeded MAC regenerates it);
* err_only: the CBD error of every slab and its negacyclic NTT (the
  error as its own tensor, which the encryption no longer makes: it draws
  the error inside the plaintext's lift);
* errntt_only: that NTT alone, on one fixed slab of residues, once a slab;
* encrypt: the whole seeded encode (``seeded.encode_seeded``: the lift with
  t e added, one NTT, c0 = u - a s with a drawn in the kernel);
* mac2: the seeded MAC of the encoded rows against two plaintext batches
  (``seeded.seeded_inner_product``, c1 regenerated), the prove side.

Each section is run once to warm, then `--reps` times between two CUDA
events (the host clock with ``--cpu``); the row has seconds per run.  The
key is threefry (``utils/prng``), the only generator of this package.

    python -m ringsnark_tpu_torch.scripts.bench_encode_profile [--rows 65536]
        [--slab 4096] [--n-inner 4096] [--L-inner 3] [--reps 4] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .common import card, device_for, emit, event_seconds, log

__all__ = ["main"]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=65536)
    ap.add_argument("--slab", type=int, default=4096)
    ap.add_argument("--n-inner", type=int, default=4096)
    ap.add_argument("--L-inner", type=int, default=3)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain twins)")
    args = ap.parse_args(argv)

    from ..encoding import EncodingContext, keygen
    from ..encoding import bgv
    from ..encoding.context import default_inner_primes
    from ..ops import ntt as nttm
    from ..rings.context import default_context
    from ..rings.elem import RingElem
    from ..snark import seeded as sd
    from ..utils import prng

    device = device_for(args.cpu)
    dev = card(device)
    ring = default_context(L=1, N=1, order=1 << 18, device=device)
    ectx = EncodingContext(ring=ring, n_inner=args.n_inner,
                           inner_primes=default_inner_primes(args.n_inner, ring.primes, args.L_inner))
    rng = np.random.default_rng(0)
    _, sk = keygen(ectx, rng)
    key = prng.key(0)
    S, B = args.slab, args.rows
    nslab = B // S
    rows = RingElem(ring, ring.tensor(np.stack(
        [rng.integers(0, p, (B, 1), dtype=np.uint64) for p in ring.primes], axis=1)))
    log(f"[cfg] rows={B} slab={S} L'={args.L_inner} N'={args.n_inner}, {dev['name']} "
        f"({dev.get('power_limit', 'cpu')})")
    plan = ectx.inner_plan(0)
    res_slab = torch.from_numpy(np.random.default_rng(1).integers(
        0, ectx.inner_primes[0], (S, 1, args.L_inner, args.n_inner), dtype=np.int64
    ).astype(np.int32)).to(device)

    def a_only():
        for i in range(nslab):
            bgv._sample_uniform(ectx, sd._slab_c1_key(key, i), (S,))

    def err_only():
        for i in range(nslab):
            nttm.negacyclic_ntt_rev(bgv._sample_error_coeffs(ectx, prng.fold_in(key, i), (S,)),
                                    plan)

    def errntt_only():
        for _ in range(nslab):
            nttm.negacyclic_ntt_rev(res_slab, plan)

    def encrypt():
        return sd.encode_seeded(ectx, sk, rows, key, S)

    senc = encrypt()

    def mac2():
        sd.seeded_inner_product(senc, [rows.res, rows.res], False)

    def timed(name, fn):
        fn()  # warm
        dt = event_seconds(lambda: [fn() for _ in range(args.reps)], device) / args.reps
        log(f"[{name}] {dt * 1e3:.3f} ms / {B} rows")
        return dt

    res = {"metric": "encode_profile", "rows": B, "slab": S, "L_inner": args.L_inner,
           "n_inner": args.n_inner, "device": dev["name"], "card": dev}
    for name, fn in (("a_only", a_only), ("err_only", err_only), ("errntt_only", errntt_only),
                     ("encrypt", encrypt), ("mac2", mac2)):
        res[f"{name}_s"] = timed(name, fn)
    return emit(res, None)


if __name__ == "__main__":
    main()
