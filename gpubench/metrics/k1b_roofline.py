"""K1b (`ops.stereo_sad.sad_refine`: SAD sweep and parabola) against its
roofline, % (benchlib/roofline.py)."""
from benchlib.roofline import share


def read(run):
    work = run["work"]
    return share(run, "k1b", lambda a, out: work.k1b(*a[:6]))
