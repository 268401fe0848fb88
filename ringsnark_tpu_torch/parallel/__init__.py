"""Multi-device sharding over ``torch.distributed``: meshes and sharded provers.

Port of ``ringsnark_tpu/parallel/``.  One process per device (NCCL on the
GPUs; gloo ranks on the CPU when asked), a named ``DeviceMesh`` over the
world, and explicit collectives where the JAX package's GSPMD inserts them.
Mesh dimensions:

* ``limb`` — outer RNS limbs: embarrassingly parallel; the limb blocks are
  gathered at the end;
* ``data`` — CRS/witness batch axis: each rank multiply-accumulates its
  rows and the exact int64 sums are ``all_reduce``d;
* ``coeff`` — transform coefficient axis: butterfly stages exchange blocks
  with ``batch_isend_irecv`` (ntt_sharded.py), for transforms larger than
  one device.

``dryrun.dryrun_multichip`` starts the ranks of a world and proves on it.
"""

from .mesh import (  # noqa: F401
    crs_sharding,
    init_rank,
    init_single_process,
    make_mesh,
    replicate,
    ring_sharding,
)
from .ntt_sharded import make_sharded_ntt, sharded_ntt  # noqa: F401
from .sharded import (  # noqa: F401
    groth16_prove_sharded,
    rinocchio_prove_sharded,
    shard_groth16_inputs,
    shard_rinocchio_inputs,
)
from .stream_sharded import stream_chunk_ip_sharded  # noqa: F401
