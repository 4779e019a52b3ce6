"""Replicated serving fleet (port of photon_ml_tpu/fleet/): replication
log, replica runtime, front.

A durable append-only ReplicationLog carries every model-state change
(full swaps, version-vectored ModelDeltas, delta-aware rollbacks) from
ONE publisher to N replica processes, each of which replays the log
through its own ModelRegistry and converges to bit-identical tables
(audited by version vector + per-table sha256); a health-probing Front
routes scoring traffic across the ready replicas with failover, hedging,
draining and explicit backpressure.  Entity-sharded serving
(fleet/shards.py) partitions the random-effect entity space across
replicas and the front re-folds per-shard margins bit-identically.

The log, the shard map and the front are host-only copies of the JAX
package's modules (a log or snapshot either package writes reads in the
other); the replica replays records through the port's registry, on the
device its service serves on.
"""
from photon_ml_tpu_torch.fleet.front import (FRONT_SNAPSHOT_PATHS,  # noqa: F401
                                             Front, FrontConfig,
                                             NoReadyReplica, ReplicaHandle)
from photon_ml_tpu_torch.fleet.replica import (FleetPublisher,  # noqa: F401
                                               Replica, ReplicaConfig,
                                               ReplicaError)
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
