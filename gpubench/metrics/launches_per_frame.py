"""Kernel launches (the host's launch records in the traced window) a
frame handed over in it."""


def read(run):
    t = run["traced"]
    if not t or not t["frames"]:
        return None
    return t["launches"] / t["frames"]
