from lins_tpu_torch.graph.pose_graph import (
    EdgeSet, empty_edges, add_edge, relative_pose, optimize, graph_cost)
from lins_tpu_torch.graph.loop_closure import (
    detect_loop, icp_align, try_close_loop)
