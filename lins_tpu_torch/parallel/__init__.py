"""Multi-device and multi-process drivers (port of `lins_tpu/parallel/`):
the mesh and process enrollment (`multihost`), the edge-sharded pose-graph
solves (`dist_graph`), the multi-stream replay (`replay`), the keyframe
store sharded along the keyframe axis (`shard_map_store`) and the dry run
(`dryrun`)."""
