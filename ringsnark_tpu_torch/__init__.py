"""ringsnark-tpu on PyTorch and CUDA: circuits, ringGroth16 and Rinocchio.

A port of the JAX package `ringsnark_tpu` (which stays the reference) to
PyTorch, with the NTT as a hand-written CUDA kernel for Hopper (`sm_90a`,
`csrc/ntt.cu`).  Sub-packages and modules carry the JAX package's names so
each counterpart is found under the same path: a circuit is written on a
`gadgets.Protoboard` (or taken from `models`), compiled, and proved and
verified with `snark.groth16` or `snark.rinocchio`.

Conventions:

* residues are < 2^31 and stored as ``torch.int32``; products are formed in
  ``int64`` and reduced with ``torch.remainder`` before any sum;
* every context carries an explicit ``device``; a CUDA tensor goes to the
  kernel, a CPU tensor to its plain PyTorch twin (``ops/ntt.py``);
* host-side secrets come from numpy ``Generator``s and encryption
  randomness from threefry keys (``utils/prng.py``), both drawn exactly as
  the JAX package draws them, so one seed and key give the same keypair.

This package never imports jax.
"""

__version__ = "0.1.0"
