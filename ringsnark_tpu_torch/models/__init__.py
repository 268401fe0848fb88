"""Application circuits mirroring the reference's examples/ and benchmarks/
workloads, the outer-FHE helper they verify, and synthetic benchmark-scale
circuits built directly as arrays.

| function                   | reference source                                   |
|----------------------------|----------------------------------------------------|
| build_toy_circuit          | examples/example_SEAL.cpp:38-119                   |
| build_toy_circuit(replicate)| examples/example_SEAL_int.cpp:39-114 (slot-split) |
| build_plaintext_check      | examples/example_plaintext_check_SEAL.cpp:47-80,   |
|                            | benchmarks/bench_plaintext_check_SEAL.cpp          |
| build_incircuit_ntt        | benchmarks/bench_ntt_SEAL.cpp:39-77                |
| build_ct_mul               | benchmarks/bench_mul_SEAL.cpp:38-90                |
| build_logreg_inference     | benchmarks/bench_logistic_regression_inference.cpp |
"""

from .fhe import OuterBGV  # noqa: F401
from .toy import build_toy_circuit  # noqa: F401
from .plaintext_check import build_plaintext_check  # noqa: F401
from .incircuit_ntt import build_incircuit_ntt, negacyclic_eval_points  # noqa: F401
from .ct_mul import build_ct_mul  # noqa: F401
from .logreg import build_logreg_inference  # noqa: F401
from .synthetic import build_synthetic_mul_chain, build_synthetic_square_chain  # noqa: F401
