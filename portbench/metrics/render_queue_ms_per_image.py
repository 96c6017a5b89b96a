"""render_queue_ms_per_image: the host's side of the card render a
decode, in ms: the program's frame.render spans (the block tables, the
transforms, K1, colour and output queued from Python) less the
render.ac_wait spans inside them (the host blocked on the card), on the
decodes with no render.host_route span (a frame rendered on the host),
summed inside the window's decodes, over the decodes."""

from portbench.spans import in_decodes, ms_per_decode

UNIT = "ms"


def read(run):
    spans = in_decodes(run, ("frame.render", "render.ac_wait", "render.host_route"))
    host_routed = {i for i, n, _, _ in spans if n == "render.host_route"}
    renders = [(s, e) for i, n, s, e in spans if n == "frame.render" and i not in host_routed]
    waits = [(s, e) for i, n, s, e in spans if n == "render.ac_wait" and i not in host_routed]
    total = sum(e - s for s, e in renders)
    total -= sum(e - s for s, e in waits if any(r0 <= s and e <= r1 for r0, r1 in renders))
    return ms_per_decode(run, total) if renders else None
