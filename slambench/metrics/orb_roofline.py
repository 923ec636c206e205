"""K2's share of its roofline (%): the least time one view's ORB
extraction needs at the configuration's shapes (``roofline.orb_view_s``),
times the views the trace holds (three K2 launches a view), over K2's
device time in the trace."""
from slambench import roofline


def read(run):
    t = run.trace
    if t is None or not t.kernel_s.get("orb"):
        return None
    cfg = run.cfg
    views = t.kernel_launches["orb"] / 3
    need = views * roofline.orb_view_s(int(cfg["Camera.height"]),
                                       int(cfg["Camera.width"]),
                                       int(cfg["ORBextractor.nFeatures"]))
    return 100.0 * need / t.kernel_s["orb"]
