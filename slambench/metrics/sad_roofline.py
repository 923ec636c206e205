"""K5's share of its roofline (%): the least time the refinement, depth
and median sweep need over the keypoints K5 refined in the traced frames
(those with an association under TH_ORB; ``roofline.sad_pair_s``), over
K5's device time in the trace."""
from slambench import roofline


def read(run):
    t = run.trace
    if t is None or not t.kernel_s.get("stereo_sad") or not t.sad_keypoints:
        return None
    return 100.0 * roofline.sad_pair_s(t.sad_keypoints) / t.kernel_s[
        "stereo_sad"]
