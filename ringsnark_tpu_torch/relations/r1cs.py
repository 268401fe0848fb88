"""R1CS constraint systems, compiled to COO tensors over a ring.

Port of ``ringsnark_tpu/relations/r1cs.py`` (after the reference's
`r1cs.hpp:50-162`): `R1CSConstraint{a,b,c}`, `R1CSConstraintSystem` with
primary/auxiliary sizes, `is_satisfied`, `is_valid`, `add_constraint`,
`swap_AB_if_beneficial` (density heuristic, `r1cs.tcc:176-226`) and a JSON
round trip in the JAX package's format.

`compile()` lowers the three sparse matrices to COO index/coefficient
tensors on the context's device.  ``CompiledR1CS.evaluate`` (and
``eval_matrices``, its public form) dispatches on the assignment's device:
on the card the matrices of a call go to ``ops/cuda_witness.spmv`` in one
launch, each with its CSR (`derive_csr`: the nonzeros stably sorted by the
rows they add into, row pointers, each row's first gather index, the rows
longer than LONG_ROW; the COO's own index and coefficient tensors where it
is in row order), derived once per compiled system and kept with it; on any
other device `spmv`, a gather, a
modular multiply and an ``index_add_`` segment sum in int64, runs (the
kernel's plain version).  JAX clamps out-of-range gathers and drops
out-of-range segment ids; torch raises or writes out of bounds, so the
indices are checked: by `spmv` on every call, by `derive_csr` once, where
an index outside the system's sizes is refused.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import cuda_witness
from ..ops.modops import mul_mod
from ..rings.context import RingContext
from ..rings.elem import RingElem
from .variable import LinearCombination, LinearTerm

__all__ = ["R1CSConstraint", "R1CSConstraintSystem", "CompiledR1CS", "CSR", "derive_csr",
           "spmv", "LONG_ROW"]


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


LONG_ROW = 32  # a row of more nonzeros is a work item of its own in spmv_kernel


@dataclass(frozen=True)
class CSR:
    """One matrix's nonzeros in the order of the rows they add into: what
    ``cuda_witness.spmv`` reads.  Row r's nonzeros are positions [ptr[r],
    ptr[r + 1]) of the COO's stable sort by row, `idx` their gather
    indices, `head` each row's first again by row (0 for an empty row), so
    the kernel reads it beside the row's bounds.  Where the COO is already
    in row order (`compile` and the models emit it so) `perm` is None and `idx` is
    the COO's own column tensor; else `perm` holds the COO position of each
    nonzero.  Where every row is one nonzero (`unit`: row r is nonzero r)
    there is no `ptr` and `head` is `idx`.  `rows` and `cols` are one past
    the largest row and gather index (the output rows and assignment rows a
    call needs).  `longs` lists the rows of more than `long_len` nonzeros,
    in order: the kernel's tiles skip them and a CTA's threads share each."""

    ptr: torch.Tensor | None  # int32 [rows + 1]; None where `unit`
    idx: torch.Tensor  # int64 [nnz]
    head: torch.Tensor  # int32 [rows]; `idx` where `unit`
    perm: torch.Tensor | None  # int64 [nnz]; None where the COO is in row order
    rows: int
    cols: int
    long_len: int
    longs: torch.Tensor  # int32 [long rows]
    max_len: int  # the longest row's nonzeros

    @property
    def unit(self) -> bool:
        return self.ptr is None

    @property
    def nlong(self) -> int:
        return self.longs.numel()


def derive_csr(scatter: torch.Tensor, gather: torch.Tensor, n_out: int, n_in: int) -> CSR:
    """The CSR of a COO matrix whose nonzero k adds into output row
    scatter[k] from assignment row gather[k].  Every index is checked here,
    once: one outside [0, n_out) or [0, n_in) raises IndexError (JAX would
    clamp or drop it, a kernel would read or write out of bounds).  Rows of
    more than LONG_ROW nonzeros are listed in `longs`.  Two reads of the
    device, three where a row is long; none on any later call."""
    dev, nnz = scatter.device, scatter.numel()
    if nnz >= 1 << 31:
        raise ValueError(f"derive_csr: {nnz} nonzeros, the kernel takes fewer than 2^31")
    scatter, gather = scatter.to(torch.int64), gather.to(torch.int64).contiguous()
    rows = cols = 0
    in_order = True
    if nnz:
        s_lo, s_hi, g_lo, g_hi, in_order = torch.stack(
            [scatter.min(), scatter.max(), gather.min(), gather.max(),
             (scatter[1:] >= scatter[:-1]).all().to(torch.int64)]).tolist()
        if s_lo < 0 or s_hi >= n_out:
            raise IndexError(f"scatter index out of range for {n_out} rows")
        if g_lo < 0 or g_hi >= n_in:
            raise IndexError(f"gather index out of range for {n_in} rows")
        rows, cols = s_hi + 1, g_hi + 1
    perm = None if in_order else torch.sort(scatter, stable=True).indices
    idx = gather if perm is None else gather[perm]
    counts = torch.bincount(scatter, minlength=rows)
    max_len = int(counts.max()) if rows else 0
    i32 = torch.int32
    longs = (torch.nonzero(counts > LONG_ROW).flatten().to(i32) if max_len > LONG_ROW
             else torch.zeros(0, dtype=i32, device=dev))
    if rows == nnz and max_len == 1:  # row r is nonzero r
        return CSR(None, idx, idx, perm, rows, cols, LONG_ROW, longs, max_len)
    ptr = torch.zeros(rows + 1, dtype=i32, device=dev)
    ptr[1:] = counts.cumsum(0)
    first = idx[ptr[:-1].clamp(max=nnz - 1).long()] if nnz else None
    head = (torch.where(counts > 0, first, 0).to(i32) if nnz
            else torch.zeros(rows, dtype=i32, device=dev))
    return CSR(ptr, idx, head, perm, rows, cols, LONG_ROW, longs, max_len)


def _window(x: torch.Tensor, lo: int, width: int | None) -> torch.Tensor:
    """Slots [lo, lo + width) of x, or x where it is one slot (a broadcast)
    or width is None (all slots)."""
    return x if width is None or x.shape[-1] == 1 else x[..., lo:lo + width]


@dataclass(frozen=True)
class CompiledR1CS:
    """COO form of the three R1CS matrices over a concrete ring.

    rows/cols: int64[nnz] per matrix (column 0 = constant 1);
    coeffs: int32[nnz, L, nc] with nc ∈ {1, N}.  All on ``ctx.device``.

    `plans` holds each matrix's `CSR` (the prover's orientation), derived
    from rows and cols at first use on the card; a system made from
    another's rows and cols (``streamed.limb_compiled``) may share its
    dict.  Coefficients are read in place where the COO is in row order.
    """

    ctx: RingContext
    num_constraints: int
    num_variables: int  # excluding the constant
    primary_input_size: int
    rows: tuple  # (rows_a, rows_b, rows_c)
    cols: tuple
    coeffs: tuple
    plans: dict = field(default_factory=dict, compare=False, repr=False)
    _coeffs: dict = field(default_factory=dict, init=False, compare=False, repr=False)

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

    def csr(self, which: int, transposed: bool = False) -> CSR:
        """Matrix `which`'s CSR (rows: the constraints; transposed: the
        variables, gathering from the constraints).  The prover's
        orientation is derived once and kept; the transposed one (the
        instance map's, once a setup) is derived for the call and dropped,
        so it holds no memory of the card past it."""
        rows, cols = self.rows[which], self.cols[which]
        nc, nv = self.num_constraints, self.num_variables + 1
        if transposed:
            return derive_csr(cols, rows, nv, nc)
        if which not in self.plans:
            self.plans[which] = derive_csr(rows, cols, nc, nv)
        return self.plans[which]

    def csr_coeffs(self, which: int, csr: CSR) -> torch.Tensor:
        """Matrix `which`'s coefficients in `csr`'s order: its own tensor
        where the COO is in row order, else a permuted copy (kept for the
        prover's orientation)."""
        if csr.perm is None:
            return self.coeffs[which]
        if csr is not self.plans.get(which):
            return self.coeffs[which][csr.perm]
        if which not in self._coeffs:
            self._coeffs[which] = self.coeffs[which][csr.perm]
        return self._coeffs[which]

    def evaluate(self, z, num_rows: int, which=(0, 1, 2), lo: int = 0, width: int | None = None,
                 slot_major: bool = False, transposed: bool = False) -> tuple:
        """The evaluations of the matrices `which` over the slot window [lo,
        lo + width) (all slots where width is None).

        z: the assignment with its leading constant, int32 [1+nv, L, n], or
        its row blocks in order (e.g. (one, primary, auxiliary)), each
        [rows, L, 1 or n]; a one-slot block or coefficient broadcasts.
        transposed: z holds one row per constraint and the result one per
        variable (the instance map's At·u).  Each result is int32
        [num_rows, L, n'], or [n', L, num_rows] where `slot_major`; n' the
        window's slots (1 where nothing is wider).  On the card the
        matrices are one ``cuda_witness.spmv``, one launch; elsewhere
        `spmv`, one a matrix."""
        blocks = (z,) if isinstance(z, torch.Tensor) else tuple(z)
        if not cuda_witness.on_card(blocks[0]):
            return tuple(self._evaluate_plain(blocks, num_rows, w, lo, width, slot_major,
                                              transposed) for w in which)
        widths = [b.shape[-1] for b in blocks] + [self.coeffs[w].shape[-1] for w in which]
        n = max(widths) if width is None else (width if max(widths) > 1 else 1)
        plans = [(csr, self.csr_coeffs(w, csr)) for w, csr in
                 ((w, self.csr(w, transposed)) for w in which)]
        return cuda_witness.spmv(plans, blocks, self.ctx.primes, num_rows, lo, n, slot_major)

    def _evaluate_plain(self, blocks, num_rows, which, lo, width, slot_major, transposed):
        blocks = [_window(b, lo, width) for b in blocks]
        n = max(b.shape[-1] for b in blocks)
        z = torch.cat([b.expand(-1, -1, n) for b in blocks]) if len(blocks) > 1 else blocks[0]
        rows, cols = self.rows[which], self.cols[which]
        if transposed:
            rows, cols = cols, rows
        out = spmv(z, _window(self.coeffs[which], lo, width), cols, rows, num_rows, self.ctx.p)
        return out.permute(2, 1, 0).contiguous() if slot_major else out

    def eval_matrices(self, full_assignment_with_one, num_rows: int | None = None):
        """(A·z, B·z, C·z) where z includes the leading constant 1.

        full_assignment_with_one: int32[1+num_variables, L, n].
        Returns three int32[num_rows, L, n'] arrays.
        """
        m = num_rows if num_rows is not None else self.num_constraints
        return self.evaluate(full_assignment_with_one, m)

    def is_satisfied(self, full_assignment_with_one) -> bool:
        az, bz, cz = self.eval_matrices(full_assignment_with_one)
        return bool(torch.equal(mul_mod(az, bz, self.ctx.p), cz))
