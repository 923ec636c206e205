from . import residuals, pose_opt, ba, pose_graph, sim3_opt  # noqa: F401
