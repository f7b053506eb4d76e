from lins_tpu_torch.graph.pose_graph import (
    EdgeSet, empty_edges, add_edge, relative_pose)
