"""k1_roofline_share: kernel K1 (gaborish and EPF, `epf_gab_kernel`) as a
share of its roofline, in %: the least time the H100 could take for the
filters of every decode in the window (the larger of the bytes over the
HBM peak and the fp32 operations over the fp32 peak) over K1's device
time in the trace. The count is the filters' own, from the frame's size
and its restoration filter (the writer's record): 28 bytes a pixel moved
once (three planes and 1/sigma in, three planes out) and the operations
of epf_gab_ops_per_px."""

from portbench import peaks

UNIT = "%"
KERNEL = "epf_gab_kernel"
GAB, EPF_ITERS = True, 2  # the default restoration filter


def epf_gab_ops_per_px(gab: bool, epf_iters: int) -> int:
    """fp32 operations per pixel of gaborish + EPF as the stage math
    counts them (adds, muls, abs, max, div; selects not counted)."""
    ops = 33 if gab else 0  # per channel 6 adds + 3 muls + 2 adds
    for step, need in ((0, 3), (1, 1), (2, 2)):
        if epf_iters < need:
            continue
        nn, npat = (12, 5) if step == 0 else (4, 5 if step == 1 else 1)
        # per neighbor: 3 channels x (npat sub + npat abs + (npat-1) add
        # + 1 mul), 2 adds over channels, weight mul+add+max, 1 sum add;
        # per pixel: 1/sigma x multiplier, wsum add, per channel nn
        # mul+add and a divide
        ops += nn * (9 * npat + 6) + 2 + 3 * (2 * nn + 1)
    return ops


def bound_s(h: int, w: int, gab: bool = GAB, epf_iters: int = EPF_ITERS) -> float:
    """The least seconds of the filters over an h x w frame."""
    t_bytes = 28 * h * w / peaks.HBM_BYTES_PER_S
    t_ops = epf_gab_ops_per_px(gab, epf_iters) * h * w / peaks.FP32_OPS_PER_S
    return max(t_bytes, t_ops)


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.device_seconds(lambda n: KERNEL in n)
    if secs <= 0:
        return None
    bound = 0.0
    for d in run.decodes:
        f = run.pool[d.index]
        if f.coded.get("filters"):
            bh, bw = f.coded["transform"].shape
            bound += bound_s(8 * bh, 8 * bw)
    return 100.0 * bound / secs if bound > 0 else None
