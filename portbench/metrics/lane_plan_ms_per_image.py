"""lane_plan_ms_per_image: the AC lane planner a decode, in ms: the
host tables of K3's lanes (vardct/device_group.py:lane_inputs, the
program's frame.lane_plan span), summed inside the window's decodes,
over the decodes."""

from portbench.spans import span_ms_per_decode

UNIT = "ms"


def read(run):
    return span_ms_per_decode(run, ("frame.lane_plan",))
