"""Mean host-clock ms per forecast from the IC in host memory to
``init_state`` returning, the device synchronised (traced runs only)."""


def read(run):
    up = run.counters.get("ic_upload_s")
    return 1e3 * sum(up) / len(up) if up else None
