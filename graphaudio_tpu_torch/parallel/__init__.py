"""Multi-device rendering on ``torch.distributed``: SPMD ranks over a
``("voice", "part")`` device mesh.

The port of graphaudio_tpu/parallel. Every rank runs the same program on its
own device (one process a rank) and receives the whole output:

* **Voice sharding**: a voice group's lanes split over the mesh's ``voice``
  dimension; each rank renders its lanes, mixes them locally (K3) and one
  ``all_reduce`` over the dimension's group completes the bus fan-in — the
  collective form of the reference's summing junction
  (AudioNodeInput.cs:100-138).
* **Partition sharding**: a partitioned convolver's IR partitions, and a
  long per-node HRIR's kernel partitions, split over ``part``; each rank
  runs the spectral MAC of its slice (K14) against the replicated delay
  line, and one ``all_reduce`` completes it
  (PartitionedConvolver.cs:154-223, distributed).

The backend is the caller's: ``torch.distributed.init_process_group`` runs
before ``make_mesh``. On one card several ranks share it over gloo (NCCL
refuses two ranks on one GPU); across cards NCCL, one rank a card.
"""

from graphaudio_tpu_torch.core.mesh import axis_size
from graphaudio_tpu_torch.parallel.sharded import ShardedVoiceScene, factor_mesh, make_mesh

__all__ = ["ShardedVoiceScene", "make_mesh", "factor_mesh", "axis_size"]
