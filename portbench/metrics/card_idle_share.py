"""card_idle_share: the share of the traced window in which nothing ran
on the card, in %: 100 - (the union of kernel, copy and set intervals) /
(the window's wall) * 100."""

UNIT = "%"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
