"""render_card_ms_per_image: the card's time a decode in the VarDCT render
and the render stages, in ms: the device time of every kernel, copy and
set in the traced window but K1's and K3's (matched by KERNELS_APART in
the profiler's kernel names), over the window's decodes."""

UNIT = "ms"
KERNELS_APART = ("ac_sections_kernel", "epf_gab_kernel")


def read(run):
    if run.trace is None or not run.decodes:
        return None
    secs = run.trace.device_seconds(lambda n: not any(k in n for k in KERNELS_APART))
    return 1e3 * secs / len(run.decodes) if secs > 0 else None
