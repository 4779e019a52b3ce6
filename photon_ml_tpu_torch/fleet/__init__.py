"""Replicated serving (port of photon_ml_tpu/fleet/, in part): the durable
replication log (`replog`) and the entity-shard map with its margin-merge
algebra (`shards`).  Both are host-only copies of the JAX package's
modules; a log or snapshot either package writes reads in the other.  The
replica runtime and the routing front (`fleet/replica.py`,
`fleet/front.py`) are ROADMAP.md queue A item 22, the fleet.
"""
from photon_ml_tpu_torch.fleet.replog import (FeedbackLog,  # noqa: F401
                                              ReplicationLog,
                                              ReplicationLogError,
                                              decode_array,
                                              delta_from_record,
                                              encode_array,
                                              feedback_from_record,
                                              record_for_event,
                                              record_for_feedback,
                                              record_for_shard_map)
from photon_ml_tpu_torch.fleet.shards import (ShardAssignment,  # noqa: F401
                                              ShardMergeError, ShardSpec,
                                              merge_margins, shards_touched)
