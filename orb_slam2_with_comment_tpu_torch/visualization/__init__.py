from .frame_drawer import draw_frame  # noqa: F401
from .map_drawer import export_map_json, export_map_ply  # noqa: F401
