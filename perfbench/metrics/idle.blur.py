"""idle.blur (%, device trace): the share of the traced window in which no
kernel, copy or memset ran on the card."""


def read(run):
    if run.dev is None or run.dev.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.dev.busy_s() / run.dev.window_s)
