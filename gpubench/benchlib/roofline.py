"""Shared by the `<kernel>_roofline` readers of gpubench/metrics/: the
share of its roofline that a kernel op reached over a traced window. The
least time is the larger of the work's bytes over 3.35 TB/s and its
float32 operations over 67 TFLOP/s (benchlib/work.py), summed over every
call in the window; the time is the profiler's device time of all the
work launched inside the op's calls. Nothing when the window has no call,
or is incomplete."""


def share(run, key, work_of):
    traced, calls = run["traced"], run["captures"].traced[key]
    dev_s = (traced or {}).get("op_device_s", {}).get(key, 0.0)
    if not calls or dev_s <= 0 or traced.get("incomplete"):
        return None
    least = sum(run["work"].bound_s(*work_of(args, out))
                for args, out in calls)
    return 100.0 * least / dev_s
