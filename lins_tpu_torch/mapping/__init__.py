from lins_tpu_torch.mapping.keyframes import (
    KeyframeStore, empty_store, add_keyframe, set_poses)
from lins_tpu_torch.mapping.scan2map import scan_to_map
from lins_tpu_torch.mapping.mapper import (
    LinsMapper, MapperState, init_mapper, mapper_state_from_numpy)
