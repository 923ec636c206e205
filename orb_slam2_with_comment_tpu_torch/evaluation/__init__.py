from .ate import ate_rmse, align_umeyama  # noqa: F401
from .rpe import rpe, kitti_segment_drift  # noqa: F401
