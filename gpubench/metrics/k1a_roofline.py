"""K1a (`ops.orb_describe.describe`: IC angle and rotated BRIEF) against its
roofline, % (benchlib/roofline.py)."""
from benchlib.roofline import share


def read(run):
    work = run["work"]
    return share(run, "k1a", lambda a, out: work.k1a(
        a[0], a[2], a[3], a[4], out[0]))
