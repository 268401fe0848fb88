"""Setup, prove and verify of the four reference circuits (the repository's
``bench_circuits.py``).

plaintext check, ct-mul, in-circuit NTT and logistic-regression inference,
each built with authentic values on a ``Protoboard`` and proved with
Rinocchio and ringGroth16 (resident CRS, or ``--streamed`` through the
limb-phased streamed provers).  One JSON line per (circuit, system); after
logreg also the FHE side (``OuterBGV``: keygen, the batched encryption of
2 x features ciphertexts, the evaluation ``fhe_eval`` and a decryption), as
the reference benches them beside its proofs.

``--preset reference`` pins each circuit to the reference's benchmark
shape (REFERENCE_SHAPES).  A resident row has a warm ``setup_s`` (a second
setup of the same circuit) beside ``setup_cold_s``.  Every timed section
ends in a synchronize; a verifier that rejects an honest proof, or accepts
one against a changed public input, raises.

    python -m ringsnark_tpu_torch.scripts.bench_circuits [--preset reference]
        [--circuit NAME] [--system groth16|rinocchio] [--streamed] [--cpu] [--out FILE]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .common import card, device_for, emit, log, peak_gib, reset_peak, timed

__all__ = ["main", "make_params", "REFERENCE_SHAPES", "BUILDERS"]

REFERENCE_SHAPES = {
    # circuit: (outer N, inner N', logT or None, features or None)
    "plaintext_check": (2048, 16384, 32, None),  # bench_plaintext_check_SEAL.cpp:19-34
    "ct_mul": (8192, 16384, 16, None),  # bench_mul_SEAL.cpp:38-49
    "incircuit_ntt": (4096, 16384, None, None),  # bench_ntt_SEAL.cpp:39-55
    "logreg": (2048, 16384, 16, 256),  # bench_logistic_regression_inference.cpp:92-125
}


def _build(name, ring, rng, log_t, nf):
    from .. import models

    if name == "plaintext_check":
        return models.build_plaintext_check(ring, rng, log_t=log_t)
    if name == "ct_mul":
        return models.build_ct_mul(ring, rng, log_t=log_t)
    if name == "incircuit_ntt":
        return models.build_incircuit_ntt(ring, rng)
    return models.build_logreg_inference(ring, rng, num_features=nf, log_t=log_t)


BUILDERS = tuple(REFERENCE_SHAPES)


def make_params(N: int, n_inner: int, max_terms: int, device: str):
    """Ring L=2 with roots of order max(2^14, 2N', 4N) and the inner chain
    `plan_inner_chain` gives for `max_terms` terms."""
    from ..encoding import EncodingContext
    from ..encoding.context import default_inner_primes
    from ..encoding.noise import plan_inner_chain
    from ..rings.context import default_context
    from ..snark.api import SnarkParams

    ring = default_context(L=2, N=N, order=max(1 << 14, 2 * n_inner, 4 * N), device=device)
    L_inner, floor = plan_inner_chain(n_inner, 31, max_terms, dense=N > 1)
    return SnarkParams(ring=ring, enc=EncodingContext(
        ring=ring, n_inner=n_inner, inner_primes=default_inner_primes(n_inner, ring.primes, L_inner),
        floor_limbs=floor))


def _verified(system, vk, primary, proof, device, what):
    ok, dt = timed(lambda: system.verifier(vk, primary, proof), device)
    if ok is not True:
        raise RuntimeError(f"{what}: the verifier rejected an honest proof")
    return dt


def _rejects(system, vk, primary, proof, what):
    if system.verifier(vk, [primary[0] + 1] + primary[1:], proof):
        raise RuntimeError(f"{what}: the verifier accepted a changed public input")


def _streamed_rows(cname, pb, params, systems, args, device, base):
    from ..rings.elem import RingElem
    from ..snark import streamed as st
    from ..utils import prng

    comp = pb.get_constraint_system().compile(params.ring)
    primary = RingElem.stack(pb.primary_input())
    aux = RingElem.stack(pb.auxiliary_input()) if pb.auxiliary_input() else []
    rows = []
    for sname, system in systems.items():
        fn = st.stream_prove if sname == "groth16" else st.stream_prove_rinocchio
        times = []
        reset_peak(device)
        for p_i in range(2):  # cold, warm
            proof = vk = None
            rec = st.StreamRecord(sync=True)
            (proof, vk, rec), _ = timed(lambda: fn(
                comp, params, primary, aux, np.random.default_rng(p_i), prng.key(p_i),
                slab=args.slab, record=rec), device)
            times.append((rec.total("setup") + rec.total("stream"), rec.total("prove")))
        what = f"{cname}/{sname} (streamed)"
        verify_cold = _verified(system, vk, pb.primary_input(), proof, device, what)
        verify_s = _verified(system, vk, pb.primary_input(), proof, device, what)
        _rejects(system, vk, pb.primary_input(), proof, what)
        (setup_cold, prove_cold), (setup_s, prove_s) = times
        log(f"[TIME] {cname:>16s}/{sname:<9s} (streamed) setup {setup_s:.3f} s (cold "
            f"{setup_cold:.3f} s)  prove {prove_s:.4f} s (cold {prove_cold:.3f} s)  verify "
            f"{verify_s:.3f} s (cold {verify_cold:.3f} s)  ({pb.num_constraints()} constraints)")
        rows.append(dict(base, metric=f"{cname}_{sname}", streamed=True, setup_s=setup_s,
                         setup_cold_s=setup_cold, prove_s=prove_s, prove_cold_s=prove_cold,
                         verify_s=verify_s, verify_cold_s=verify_cold,
                         proof_bits=proof.size_in_bits(), peak_gib=peak_gib(device),
                         proof=proof))
    return rows


def _resident_rows(cname, pb, params, systems, device, base, rng):
    from ..utils import prng

    rows = []
    for sname, system in systems.items():
        def setup(seed_rng):
            return timed(lambda: system.generator(pb.get_constraint_system(), params, seed_rng,
                                                  prng.key(1)), device)

        # the cold keypair proves (drawn from the circuit's rng, as the JAX
        # script draws it); a second setup of the same circuit gives the warm time
        reset_peak(device)
        kp, setup_cold = setup(rng)
        setup_s = setup(np.random.default_rng(2))[1]

        def prove():
            return system.prover(kp.pk, pb.primary_input(), pb.auxiliary_input(),
                                 np.random.default_rng(7))

        proof, prove_cold = timed(prove, device)
        proof, prove_s = timed(prove, device)
        what = f"{cname}/{sname}"
        verify_cold = _verified(system, kp.vk, pb.primary_input(), proof, device, what)
        verify_s = _verified(system, kp.vk, pb.primary_input(), proof, device, what)
        _rejects(system, kp.vk, pb.primary_input(), proof, what)
        log(f"[TIME] {cname:>16s}/{sname:<9s} setup {setup_s:.3f} s (cold {setup_cold:.3f} s)  "
            f"prove {prove_s:.4f} s (cold {prove_cold:.3f} s)  verify {verify_s:.3f} s (cold "
            f"{verify_cold:.3f} s)  ({pb.num_constraints()} constraints)")
        rows.append(dict(base, metric=f"{cname}_{sname}", setup_s=setup_s,
                         setup_cold_s=setup_cold, prove_s=prove_s, prove_cold_s=prove_cold,
                         verify_s=verify_s, verify_cold_s=verify_cold,
                         proof_bits=proof.size_in_bits(), peak_gib=peak_gib(device),
                         proof=proof))
    return rows


def fhe_side(ring, log_t: int, nf: int, device: str, dev_name: str) -> dict:
    """Keygen, 2 nf encryptions in two batches, the evaluation (nf ct-ct
    products summed, then a degree-2 square) and one decryption."""
    from ..models.fhe import OuterBGV
    from ..rings.elem import RingElem
    from ..utils import prng

    fhe, keygen_s = timed(lambda: OuterBGV(ring, log_t, np.random.default_rng(3)), device)
    base = torch.zeros((nf, ring.N), dtype=torch.int64, device=device)
    msgs1, msgs2 = base.clone(), base.clone()
    msgs1[:, 0] = torch.arange(nf, device=device) % (1 << log_t)
    msgs2[:, 0] = (2 * torch.arange(nf, device=device) + 1) % (1 << log_t)
    ekey = prng.key(77)
    _, enc_cold = timed(lambda: fhe.encrypt_batch(msgs1, key=prng.fold_in(ekey, 9)), device)
    ((c0_1, c1_1), (c0_2, c1_2)), enc_s = timed(
        lambda: (fhe.encrypt_batch(msgs1, key=ekey),
                 fhe.encrypt_batch(msgs2, key=prng.fold_in(ekey, 1))), device)
    cts1 = [(c0_1[i], c1_1[i]) for i in range(nf)]
    cts2 = [(c0_2[i], c1_2[i]) for i in range(nf)]

    def fhe_eval():
        acc = [RingElem.zero(ring)] * 3
        for ct1, ct2 in zip(cts1, cts2):
            acc = [a + b for a, b in zip(acc, OuterBGV.multiply(ct1, ct2))]
        # degree-2 sigmoid: square the 3-component result
        return [acc[0] * acc[0], (acc[0] + acc[0]) * acc[1],
                acc[0] * acc[2] + acc[0] * acc[2] + acc[1] * acc[1], acc[1] * acc[2],
                acc[2] * acc[2]]

    _, eval_cold = timed(fhe_eval, device)
    sq, eval_s = timed(fhe_eval, device)
    _, dec_s = timed(lambda: fhe.decrypt((sq[0], sq[1], sq[2])), device)
    log(f"[TIME] {'fhe side':>16s}  keygen {keygen_s:.4f} s  enc({2 * nf} cts) {enc_s:.4f} s "
        f"(cold {enc_cold:.3f} s)  eval {eval_s:.4f} s (cold {eval_cold:.3f} s)  dec {dec_s:.3f} s")
    return {"metric": "logreg_fhe_side", "N": ring.N, "features": nf,
            "fhe_keygen_s": keygen_s, "fhe_enc_s": enc_s, "fhe_enc_cold_s": enc_cold,
            "fhe_enc_count": 2 * nf, "fhe_eval_s": eval_s, "fhe_eval_cold_s": eval_cold,
            "fhe_dec_s": dec_s, "device": dev_name}


def main(argv: list[str] | None = None) -> dict:
    """Returns {"rows": [...]}: every row printed, each with its proof under
    "proof" (left out of the printed line)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--N", type=int, default=256)
    ap.add_argument("--n-inner", type=int, default=1024)
    ap.add_argument("--features", type=int, default=32)
    ap.add_argument("--logT", type=int, default=16)
    ap.add_argument("--preset", choices=["custom", "reference"], default="custom")
    ap.add_argument("--circuit", choices=BUILDERS, default=None,
                    help="run only this circuit (default: all four)")
    ap.add_argument("--system", choices=["rinocchio", "groth16"], default=None)
    ap.add_argument("--streamed", action="store_true",
                    help="prove through the limb-phased streamed provers")
    ap.add_argument("--slab", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain twins)")
    ap.add_argument("--out", default=None, help="append the rows to this file")
    args = ap.parse_args(argv)

    from ..snark import groth16, rinocchio

    device = device_for(args.cpu)
    dev = card(device)
    systems = {"rinocchio": rinocchio, "groth16": groth16}
    if args.system:
        systems = {args.system: systems[args.system]}
    rows = []
    for cname in [args.circuit] if args.circuit else BUILDERS:
        if args.preset == "reference":
            N, n_inner, log_t, nf = REFERENCE_SHAPES[cname]
            log_t, nf = log_t or args.logT, nf or args.features
        else:
            N, n_inner, log_t, nf = args.N, args.n_inner, args.logT, args.features
        params = make_params(N, n_inner, max(4 * nf + 8, N + 2, log_t + 2), device)
        ring = params.ring
        log(f"[cfg] {cname}: N={N} L=2, N'={n_inner} L'={params.enc.L_inner} "
            f"floor={params.enc.floor_limbs}, {dev['name']} ({dev.get('power_limit', 'cpu')})")
        rng = np.random.default_rng(0)
        pb = _build(cname, ring, rng, log_t, nf)
        if not pb.is_satisfied():
            raise RuntimeError(f"{cname}: the witness does not satisfy the circuit")
        base = {"constraints": pb.num_constraints(), "N": N, "n_inner": n_inner,
                "device": dev["name"], "card": dev}
        if args.streamed:
            rows += _streamed_rows(cname, pb, params, systems, args, device, base)
        else:
            rows += _resident_rows(cname, pb, params, systems, device, base, rng)
        if cname == "logreg":
            rows.append(fhe_side(ring, log_t, nf, device, dev["name"]))
    for row in rows:
        emit({k: v for k, v in row.items() if k != "proof"}, args.out)
    return {"rows": rows}


if __name__ == "__main__":
    main()
