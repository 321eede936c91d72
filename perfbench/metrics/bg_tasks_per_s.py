"""bg_tasks_per_s (tasks/s, host clock): background blur tasks whose result
reached the client inside the window, over the window."""
from perfbench.harness.readers import done_in_window


def read(run):
    return len(done_in_window(run)) / run.seconds
