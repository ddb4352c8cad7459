"""95th percentile over all steps of the window of a step's latency on the
host clock: from the previous output landing in host memory to this one,
for a forecast's first step from its start with the IC in host memory."""


def read(run):
    lat = run.state.get("latencies") if run.traffic["kind"] == "forecast" else None
    if not lat:
        return None
    s = sorted(lat)
    pos = 0.95 * (len(s) - 1)  # linear interpolation between the order statistics
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return 1e3 * (s[lo] + (s[hi] - s[lo]) * (pos - lo))
