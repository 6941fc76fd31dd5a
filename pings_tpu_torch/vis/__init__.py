from pings_tpu_torch.vis.packet import VisPacket
from pings_tpu_torch.vis.viewer import write_viewer

__all__ = ["VisPacket", "write_viewer"]
