"""Multi-device and multi-process drivers (port of `lins_tpu/parallel/`):
the mesh and process enrollment (`multihost`), the edge-sharded pose-graph
solves (`dist_graph`), the multi-stream replay (`replay`) and the dry run
(`dryrun`).  The sharded keyframe store is not ported yet."""
