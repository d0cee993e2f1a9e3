"""The device's idle share, % (device trace): 1 minus the union of the
device's kernels, copies and sets over the profiled slice of the window.
Each cell's ``device_idle_pct.<cell kind>`` reader is this one."""


def read(run):
    p = run.profile
    if p is None or not p["device"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
