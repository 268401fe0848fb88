"""The ZK witness map of ringsnark_tpu_torch against the JAX package, on the
CPU, bit for bit (the reduction the streamed Rinocchio prover runs):

* ``_assignment_batches`` (full/io/mid) from RingElem batches and lists;
* ``witness_map_kernel_chunked`` in modes "all" and "mid", with nonzero
  d's as [L, 1] constants and as [L, n] per-slot vectors, slot-chunked
  (``slot_chunk=2`` at N=8, the JAX package's chunked path too) and not;
* the prover mode (``prover_witness_map_chunked``) equals a_io + a_mid,
  b_io + b_mid and H of mode "all" with zero d's;
* ``RingElem.random_nonzero_element`` makes the JAX package's draws.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ringsnark_tpu.models.synthetic import build_synthetic_square_chain as jsquare_chain
from ringsnark_tpu.reductions import r1cs_to_qrp as jq
from ringsnark_tpu.rings.context import default_context as jdefault_context
from ringsnark_tpu.rings.elem import RingElem as JRingElem
from ringsnark_tpu.utils.domain import RootsDomain as JRootsDomain
from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
from ringsnark_tpu_torch.ops.modops import add_mod
from ringsnark_tpu_torch.reductions import r1cs_to_qrp as tq
from ringsnark_tpu_torch.rings.context import RingContext
from ringsnark_tpu_torch.rings.elem import RingElem
from ringsnark_tpu_torch.utils.domain import RootsDomain

M = 16
L = 2
N = 8


def _u(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


@pytest.fixture(scope="module")
def chain():
    """The squaring chain (M=16, L=2, N=8) in both packages, one seed."""
    jring = jdefault_context(L=L, N=N, order=1 << 10)
    tring = RingContext(primes=jring.primes, N=N, device="cpu")
    jcomp, jprim, jaux = jsquare_chain(jring, M, np.random.default_rng(0))
    tcomp, tprim, taux = build_synthetic_square_chain(tring, M, np.random.default_rng(0))
    assert np.array_equal(_u(taux.res), np.asarray(jaux.res))
    return dict(jring=jring, tring=tring, jcomp=jcomp, jprim=jprim, jaux=jaux, tcomp=tcomp,
                tprim=tprim, taux=taux, jdom=JRootsDomain(jring, M), tdom=RootsDomain(tring, M))


def _ds(ring, jring, seed, per_slot):
    """Three nonzero d's, [L, N] per-slot vectors or [L, 1] constants."""
    rng = np.random.default_rng(seed)
    n = ring.N if per_slot else 1
    ds = [np.stack([rng.integers(1, p, n, dtype=np.uint64) for p in ring.primes]).astype(np.uint32)
          for _ in range(3)]
    return [jnp.asarray(d) for d in ds], [ring.tensor(d) for d in ds]


@pytest.mark.parametrize("as_list", [False, True], ids=["batches", "lists"])
def test_assignment_batches_equal_jax(chain, as_list):
    jp, ja, tp, ta = chain["jprim"], chain["jaux"], chain["tprim"], chain["taux"]
    if as_list:
        jp, ja, tp, ta = list(jp), list(ja)[:5], list(tp), list(ta)[:5]
    want = jq._assignment_batches(chain["jring"], jp, ja)
    got = tq._assignment_batches(chain["tring"], tp, ta)
    for g, w in zip(got, want):
        assert np.array_equal(_u(g.res), np.asarray(w.res))


@pytest.mark.parametrize("outputs", ["all", "mid"])
@pytest.mark.parametrize("per_slot", [False, True], ids=["d_const", "d_per_slot"])
def test_witness_map_kernel_chunked_equals_jax(chain, outputs, per_slot):
    jd, td = _ds(chain["tring"], chain["jring"], seed=3, per_slot=per_slot)
    jf, ji, jm = jq._assignment_batches(chain["jring"], chain["jprim"], chain["jaux"])
    tf, ti, tm = tq._assignment_batches(chain["tring"], chain["tprim"], chain["taux"])
    want = jq.witness_map_kernel_chunked(chain["jcomp"], jf.res, ji.res, jm.res, *jd,
                                         chain["jdom"], slot_chunk=2, outputs=outputs)
    chunked = tq.witness_map_kernel_chunked(chain["tcomp"], tf.res, ti.res, tm.res, *td,
                                            chain["tdom"], slot_chunk=2, outputs=outputs)
    whole = tq.witness_map_kernel_chunked(chain["tcomp"], tf.res, ti.res, tm.res, *td,
                                          chain["tdom"], outputs=outputs)
    assert len(want) == len(chunked) == (8 if outputs == "all" else 4)
    for w, c, h in zip(want, chunked, whole):
        assert np.array_equal(_u(c), np.asarray(w))
        assert torch.equal(c, h)
    if outputs == "all":
        assert tuple(chunked[6].shape) == (M + 1, L, 1)  # Z, slot-independent


def test_prover_mode_is_io_plus_mid(chain):
    """(a_full, b_full, H) of the prover mode == (a_io + a_mid, b_io + b_mid,
    H) of mode "all" with d1 = d2 = d3 = 0 (linearity; io + mid = full)."""
    ring, p = chain["tring"], chain["tring"].p
    zero = RingElem.zero(ring).res
    tf, ti, tm = tq._assignment_batches(ring, chain["tprim"], chain["taux"])
    a_io, b_io, _, a_mid, b_mid, _, _, H = tq.witness_map_kernel_chunked(
        chain["tcomp"], tf.res, ti.res, tm.res, zero, zero, zero, chain["tdom"], slot_chunk=2)
    a_full, b_full, H_p = tq.prover_witness_map_chunked(
        chain["tcomp"], chain["tprim"].res, chain["taux"].res, chain["tdom"], slot_chunk=2)
    assert torch.equal(a_full, add_mod(a_io, a_mid, p))
    assert torch.equal(b_full, add_mod(b_io, b_mid, p))
    assert torch.equal(H_p, H)


@pytest.mark.parametrize("n", [1, 8])
def test_random_nonzero_element_same_draws(n):
    jring = jdefault_context(L=L, N=n, order=1 << 10)
    tring = RingContext(primes=jring.primes, N=n, device="cpu")
    jrng, trng = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        w = JRingElem.random_nonzero_element(jring, jrng)
        g = RingElem.random_nonzero_element(tring, trng)
        assert np.array_equal(g.numpy(), np.asarray(w.res)) and not g.is_zero()
    assert jrng.integers(1 << 30) == trng.integers(1 << 30)  # same draws consumed
