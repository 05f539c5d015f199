"""K2g (`ops.match_best2.gated_best2`: gated Hamming best-2) against its
roofline, % (benchlib/roofline.py)."""
from benchlib.roofline import share


def read(run):
    work = run["work"]

    def of(a, out):
        a = a[:12]
        if a[0].dim() == 2:
            a = [x[None] for x in a]
        return work.k2g(*a)
    return share(run, "k2g", of)
