"""Ring context: the immutable parameter object threaded through all APIs.

Port of ``ringsnark_tpu/rings/context.py``, with an explicit ``device``: the
limb constants are tensors on it, and every tensor made for this ring is
made there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property, lru_cache

import numpy as np
import torch

from ..ops import primes as _primes
from ..ops import ntt as _ntt

__all__ = ["RingContext", "default_context"]


@dataclass(frozen=True)
class RingContext:
    """Parameters of the ring R = Z_q[X]/(X^N+1) with q = prod(primes).

    N == 1 gives the integer ring Z_q.  Ring elements are stored in slot
    form (negacyclic-NTT evaluation order, bit-reversed labeling — see
    ops/ntt.py); multiplication is pointwise.
    """

    primes: tuple[int, ...]
    N: int = 1
    device: str = "cuda"

    def __post_init__(self):
        assert len(self.primes) >= 1
        assert self.N == 1 or (self.N & (self.N - 1)) == 0
        for p in self.primes:
            assert p < (1 << 31), "limb primes must fit int32 with headroom"
            if self.N > 1:
                assert (p - 1) % (2 * self.N) == 0, (
                    f"prime {p} is not NTT-friendly for negacyclic degree {self.N}"
                )
        # one spelling per device ("cuda" and "cuda:0" are different strings)
        object.__setattr__(self, "device", _canon_device(self.device))

    @property
    def L(self) -> int:
        return len(self.primes)

    @property
    def q(self) -> int:
        return math.prod(self.primes)

    @cached_property
    def p(self) -> torch.Tensor:
        """Limb primes as int64 ``[L, 1]`` on the device."""
        return torch.tensor(self.primes, dtype=torch.int64, device=self.device)[:, None]

    @cached_property
    def ntt_plan(self) -> _ntt.NTTPlan | None:
        if self.N == 1:
            return None
        return _ntt.get_plan(self.primes, self.N, negacyclic=True)

    def to_rns(self, x: int) -> np.ndarray:
        """Residues of an integer, shape [L] uint32."""
        return np.array([x % p for p in self.primes], dtype=np.uint32)

    def from_rns(self, residues) -> int:
        return _primes.crt_compose([int(r) for r in residues], list(self.primes))

    def tensor(self, arr) -> torch.Tensor:
        """A numpy residue array (uint32 or smaller) as int32 on the device."""
        a = np.ascontiguousarray(np.asarray(arr).astype(np.uint32))
        return torch.from_numpy(a.view(np.int32)).to(self.device)

    def canonical(self, t: torch.Tensor) -> torch.Tensor:
        """Unsigned 32-bit words [..., L, n] (as int32 or wider) reduced mod
        each limb's prime, as int32 on the device: the sign bit of an int32
        word is the word's bit 31, not a sign."""
        return canonical_residues(t.to(self.device), self.p)


def canonical_residues(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """t: words of [..., K, n] (int32 read as unsigned 32 bits, or wider),
    p: int64 [K, 1] primes on t's device -> int32 residues in [0, p)."""
    return torch.remainder(t.to(torch.int64) & 0xFFFFFFFF, p).to(torch.int32)


def _canon_device(device) -> str:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return str(d)


@lru_cache(maxsize=None)
def default_context(
    L: int = 3, N: int = 1, order: int = 1 << 21, device: str = "cuda"
) -> RingContext:
    """Convenience preset: L limbs of ~31-bit primes ≡ 1 mod `order`."""
    ps = tuple(_primes.find_ntt_primes(L, order))
    return RingContext(primes=ps, N=N, device=device)
