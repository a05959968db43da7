from fastvideocodec_torch.gop.decode_graph import build_lsvc_decode
from fastvideocodec_torch.gop.engine import rollout
from fastvideocodec_torch.gop.graph import TreeSchedule, tree_schedule

__all__ = ["TreeSchedule", "build_lsvc_decode", "rollout", "tree_schedule"]
