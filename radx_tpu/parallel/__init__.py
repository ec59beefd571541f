"""Multi-chip / multi-host layer — the capability the reference lacks
entirely (SURVEY §2e: no NCCL/MPI/sockets anywhere; single device, single
queue).  Design: jax.sharding.Mesh + shard_map; XLA hands the collectives
(all_gather for the splitter samples, ppermute for the key exchange) to
NCCL, over NVLink between the cards of a host.
"""

from radx_tpu.parallel.mesh import make_mesh  # noqa: F401
from radx_tpu.parallel import dist_sort  # noqa: F401
