"""host_ms_per_image: the host parse and entropy decode a decode, in ms:
the mean of DecodedImage.timings["host_s"] (the host clock around the
parse and entropy decode of every frame) over the window's decodes."""

UNIT = "ms"


def read(run):
    host = [d.host_s for d in run.decodes if d.host_s is not None]
    return 1e3 * sum(host) / len(host) if host else None
