"""Host ms of a keyframe's mapping step (`kf_timings[...]["mapper"]`: the
staged mapper's dispatch on the pipelined route), the mean over the
keyframes made in the window."""


def read(run):
    kf = run["window"]["kf"]
    if not kf:
        return None
    return 1e3 * sum(k["mapper"] for k in kf) / len(kf)
