"""The port's entry-point scripts, each the counterpart of the repository's
script of the same name (``bench.py``, ``bench_prover.py``, ...):

| module                 | measures                                                      |
|------------------------|---------------------------------------------------------------|
| bench                  | the north-star NTT: N=8192, 6 limbs, batch 32, and the CPU legs |
| bench_prover           | ringGroth16 on the squaring chain: seeded, or streamed (--phased) |
| bench_circuits         | the four reference circuits, both proof systems, the FHE side  |
| bench_cpu_full         | the measured same-algorithm CPU prover                        |
| bench_encode_profile   | the seeded encode's sections: draws, encryption, MAC          |
| bench_scaling          | the sharded witness-map NTT and MAC at 1, 2, 4, 8 ranks       |

Run one as ``python -m ringsnark_tpu_torch.scripts.<name> [options]``; each
also exposes ``main(argv) -> dict``, which returns the row it prints.  They
run on the card unless given ``--cpu`` and raise where there is no card.
A row goes to stdout as one JSON line; ``--out FILE`` (appended to) is the
only way a script writes a file.
"""
