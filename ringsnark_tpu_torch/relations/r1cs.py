"""R1CS constraint systems, compiled to COO tensors over a ring.

Port of ``ringsnark_tpu/relations/r1cs.py`` (after the reference's
`r1cs.hpp:50-162`): `R1CSConstraint{a,b,c}`, `R1CSConstraintSystem` with
primary/auxiliary sizes, `is_satisfied`, `is_valid`, `add_constraint`,
`swap_AB_if_beneficial` (density heuristic, `r1cs.tcc:176-226`) and a JSON
round trip in the JAX package's format.

`compile()` lowers the three sparse matrices to COO index/coefficient
tensors on the context's device; ``eval_matrices`` is a gather, a modular
multiply and an ``index_add_`` segment sum.  JAX clamps out-of-range gathers
and drops out-of-range segment ids; torch raises or writes out of bounds,
so the indices are checked here instead.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.modops import mul_mod
from ..rings.context import RingContext
from ..rings.elem import RingElem
from .variable import LinearCombination, LinearTerm

__all__ = ["R1CSConstraint", "R1CSConstraintSystem", "CompiledR1CS", "spmv"]


class R1CSConstraint:
    """<a,(1,x)> * <b,(1,x)> = <c,(1,x)>  (r1cs.hpp:50-74)."""

    __slots__ = ("a", "b", "c")

    def __init__(self, a, b, c):
        self.a = LinearCombination(a) if not isinstance(a, LinearCombination) else a
        self.b = LinearCombination(b) if not isinstance(b, LinearCombination) else b
        self.c = LinearCombination(c) if not isinstance(c, LinearCombination) else c

    def __repr__(self):
        return f"({self.a!r}) * ({self.b!r}) = ({self.c!r})"


@dataclass
class R1CSConstraintSystem:
    primary_input_size: int = 0
    auxiliary_input_size: int = 0
    constraints: list = field(default_factory=list)
    # debug annotation maps (reference r1cs.hpp:135-138, DEBUG-gated there)
    constraint_annotations: dict = field(default_factory=dict)
    variable_annotations: dict = field(default_factory=dict)

    def num_inputs(self) -> int:
        return self.primary_input_size

    def num_variables(self) -> int:
        return self.primary_input_size + self.auxiliary_input_size

    def num_constraints(self) -> int:
        return len(self.constraints)

    def add_constraint(self, c: R1CSConstraint, annotation: str | None = None):
        if annotation is not None:
            self.constraint_annotations[len(self.constraints)] = annotation
        self.constraints.append(c)

    def is_valid(self) -> bool:
        if self.primary_input_size > self.num_variables():
            return False
        nv = self.num_variables() + 1
        return all(
            cons.a.is_valid(nv) and cons.b.is_valid(nv) and cons.c.is_valid(nv)
            for cons in self.constraints
        )

    def is_satisfied(self, primary_input: list, auxiliary_input: list) -> bool:
        """Host-path satisfaction check (r1cs.tcc:121-159), one constraint at
        a time.  For the batched check use `CompiledR1CS.is_satisfied`.
        """
        assert len(primary_input) == self.num_inputs()
        assert len(primary_input) + len(auxiliary_input) == self.num_variables()
        full = list(primary_input) + list(auxiliary_input)
        one = _one_like(full)
        for cons in self.constraints:
            ares = cons.a.evaluate(full, one)
            bres = cons.b.evaluate(full, one)
            cres = cons.c.evaluate(full, one)
            if not (ares * bres == cres):
                return False
        return True

    def swap_AB_if_beneficial(self):
        """Swap a<->b in every constraint if B touches more variables than A
        (r1cs.tcc:176-226)."""
        touched_a, touched_b = set(), set()
        for cons in self.constraints:
            touched_a.update(t.index for t in cons.a.terms)
            touched_b.update(t.index for t in cons.b.terms)
        if len(touched_b) > len(touched_a):
            for cons in self.constraints:
                cons.a, cons.b = cons.b, cons.a

    def __eq__(self, other):
        return (
            isinstance(other, R1CSConstraintSystem)
            and self.primary_input_size == other.primary_input_size
            and self.auxiliary_input_size == other.auxiliary_input_size
            and len(self.constraints) == len(other.constraints)
            and all(
                ca.a == cb.a and ca.b == cb.b and ca.c == cb.c
                for ca, cb in zip(self.constraints, other.constraints)
            )
        )

    # ---- compilation -------------------------------------------------------

    def compile(self, ctx: RingContext) -> "CompiledR1CS":
        return CompiledR1CS.build(self, ctx)

    # ---- serialization: the JAX package's JSON, so a file saved by either
    # package loads in the other ---------------------------------------------

    def save(self, path: str):
        def lc_json(lc):
            return [
                [t.index, int(t.coeff) if isinstance(t.coeff, int) else None,
                 None if isinstance(t.coeff, int) else t.coeff.numpy().tolist()]
                for t in lc.terms
            ]

        obj = {
            "primary_input_size": self.primary_input_size,
            "auxiliary_input_size": self.auxiliary_input_size,
            "constraints": [
                [lc_json(c.a), lc_json(c.b), lc_json(c.c)] for c in self.constraints
            ],
        }
        with open(path, "w") as f:
            json.dump(obj, f)

    @classmethod
    def load(cls, path: str, ctx: RingContext | None = None):
        with open(path) as f:
            obj = json.load(f)

        def lc_from(ts):
            lc = LinearCombination()
            for idx, ic, rc in ts:
                if ic is not None:
                    lc.terms.append(LinearTerm(idx, ic))
                else:
                    assert ctx is not None, "ring coeffs need a ctx to load"
                    lc.terms.append(
                        LinearTerm(idx, RingElem(ctx, ctx.tensor(np.array(rc, dtype=np.uint32))))
                    )
            return lc

        cs = cls(obj["primary_input_size"], obj["auxiliary_input_size"])
        for a, b, c in obj["constraints"]:
            cs.constraints.append(R1CSConstraint(lc_from(a), lc_from(b), lc_from(c)))
        return cs


def _one_like(assignment):
    for v in assignment:
        return type(v).one(v.ctx)
    raise ValueError("cannot infer ring from empty assignment")


def _coo_matrix(ctx: RingContext, lcs):
    """(rows, cols, coeffs) tensors of one matrix, row i being lcs[i].

    Integer coefficients are reduced on the host and uploaded as one array
    (not one device copy per term); `RingElem` coefficients stay on the
    device and are written into their rows.  coeffs is ``[nnz, L, nc]``,
    nc the widest coefficient (1, or N when any term is dense), and
    ``[0, L, 1]`` for an empty matrix.
    """
    rows, cols, ints, elems = [], [], [], []
    for i, lc in enumerate(lcs):
        for t in lc.terms:
            if isinstance(t.coeff, RingElem):
                assert t.coeff.ctx == ctx and t.coeff.res.ndim == 2
                elems.append((len(rows), t.coeff))
                ints.append(0)
            else:
                ints.append(int(t.coeff))
            rows.append(i)
            cols.append(t.index)

    def idx(a):
        return torch.from_numpy(np.array(a, dtype=np.int64)).to(ctx.device)

    host = np.array([[c % p for c in ints] for p in ctx.primes], dtype=np.uint32)
    coeffs = ctx.tensor(host.reshape(ctx.L, len(ints)).T[:, :, None])  # [nnz, L, 1]
    if elems:
        nc = max(e.res.shape[-1] for _, e in elems)
        coeffs = coeffs.expand(-1, -1, nc).contiguous()
        coeffs[idx([k for k, _ in elems])] = torch.stack(
            [e.res.expand(ctx.L, nc) for _, e in elems])
    return idx(rows), idx(cols), coeffs


def spmv(vals, coeffs, gather_idx, scatter_idx, num_out: int, p):
    """out[s] = sum over nnz with scatter_idx == s of vals[gather_idx] * coeff.

    vals: int32[R, L, n]; coeffs: int32[nnz, L, nc]; indices int64[nnz].
    Each product is reduced mod p before the sum, so the int64 sum of up to
    2^31 terms cannot overflow.
    """
    if gather_idx.numel():
        if int(gather_idx.min()) < 0 or int(gather_idx.max()) >= vals.shape[0]:
            raise IndexError(f"gather index out of range for {vals.shape[0]} rows")
        if int(scatter_idx.min()) < 0 or int(scatter_idx.max()) >= num_out:
            raise IndexError(f"scatter index out of range for {num_out} rows")
    prods = torch.remainder(vals[gather_idx].to(torch.int64) * coeffs.to(torch.int64), p)
    acc = torch.zeros((num_out, *prods.shape[1:]), dtype=torch.int64, device=vals.device)
    acc.index_add_(0, scatter_idx, prods)
    return torch.remainder(acc, p).to(torch.int32)


@dataclass(frozen=True)
class CompiledR1CS:
    """COO form of the three R1CS matrices over a concrete ring.

    rows/cols: int64[nnz] per matrix (column 0 = constant 1);
    coeffs: int32[nnz, L, nc] with nc ∈ {1, N}.  All on ``ctx.device``.
    """

    ctx: RingContext
    num_constraints: int
    num_variables: int  # excluding the constant
    primary_input_size: int
    rows: tuple  # (rows_a, rows_b, rows_c)
    cols: tuple
    coeffs: tuple

    @classmethod
    def build(cls, cs: R1CSConstraintSystem, ctx: RingContext) -> "CompiledR1CS":
        rows, cols, coeffs = zip(*(
            _coo_matrix(ctx, [getattr(cons, which) for cons in cs.constraints])
            for which in ("a", "b", "c")))
        return cls(
            ctx=ctx,
            num_constraints=cs.num_constraints(),
            num_variables=cs.num_variables(),
            primary_input_size=cs.primary_input_size,
            rows=rows,
            cols=cols,
            coeffs=coeffs,
        )

    def eval_matrices(self, full_assignment_with_one, num_rows: int | None = None):
        """(A·z, B·z, C·z) where z includes the leading constant 1.

        full_assignment_with_one: int32[1+num_variables, L, n].
        Returns three int32[num_rows, L, n'] arrays.
        """
        m = num_rows if num_rows is not None else self.num_constraints
        return tuple(
            spmv(full_assignment_with_one, coeffs, cols, rows, m, self.ctx.p)
            for rows, cols, coeffs in zip(self.rows, self.cols, self.coeffs)
        )

    def is_satisfied(self, full_assignment_with_one) -> bool:
        az, bz, cz = self.eval_matrices(full_assignment_with_one)
        return bool(torch.equal(mul_mod(az, bz, self.ctx.p), cz))
