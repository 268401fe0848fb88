"""What the parity tests of the port's scripts and examples share: the JAX
package's parameters built as the repository's scripts build them, and an
exact comparison of a port proof with a JAX proof."""

import numpy as np

from ringsnark_tpu.encoding import EncodingContext as JEncodingContext
from ringsnark_tpu.ops.primes import find_ntt_primes
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.snark import groth16 as jg16
from ringsnark_tpu.snark.api import SnarkParams as JSnarkParams
from ringsnark_tpu_torch.utils import interop

G16 = ("A", "B", "C")
RIN = ("A", "A_prime", "B", "B_prime", "C", "C_prime", "D", "D_prime", "F")


def jax_triples(proof):
    names = G16 if isinstance(proof, jg16.Proof) else RIN
    return [None if getattr(proof, n) is None else
            (np.asarray(getattr(proof, n).c0), np.asarray(getattr(proof, n).c1),
             getattr(proof, n).level) for n in names]


def assert_same_proof(port_proof, jax_proof):
    got, want = interop.proof_to_numpy(port_proof), jax_triples(jax_proof)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g[2] == w[2] and np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


def jax_inner(n_inner, count, outer):
    found, below = [], 1 << 31
    while len(found) < count:
        c = find_ntt_primes(1, 2 * n_inner, below=below)[0]
        below = c
        if c not in outer:
            found.append(c)
    return tuple(found)


def jax_params(L, N, n_inner, order, L_inner, floor=None):
    ring = jdefault_context(L=L, N=N, order=order)
    kw = {} if floor is None else {"floor_limbs": floor}
    return JSnarkParams(ring=ring, enc=JEncodingContext(
        ring=ring, n_inner=n_inner, inner_primes=jax_inner(n_inner, L_inner, ring.primes), **kw))
