"""region.copy_ms_per_task (ms, device trace): the card's host-to-device and
device-to-host copy time inside the window, over the blur tasks whose
result reached the client inside the window."""
from perfbench.harness.readers import done_in_window


def read(run):
    n = len(done_in_window(run))
    if run.dev is None or n == 0:
        return None
    s = sum(e.dur_us for d in ("HtoD", "DtoH") for e in run.dev.copies(d))
    return s / 1e3 / n
