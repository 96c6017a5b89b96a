#!/usr/bin/env python3
"""The host render route against the card route on the 256x256 and
512x512 VarDCT stills, for two checkouts in turns (the first, the second,
the second, the first), in one machine call:

    python3 tools/host_route_ab.py PARENT_DIR CHANGE_DIR

Each turn is a fresh process in that checkout that builds its kernels and
runs its own chip_smoke.py's host_route phase (phase_host_route) on the
two stills (encode_xyb_vardct(256, 256, seed=41) and (512, 512,
seed=42)); the script prints, for each turn, the checkout, the exit code
and the phase's summary line (each stream's card and host route walls,
u8 and f32, medians of 5, the route auto takes and whether the host won).
Needs a CUDA card, as chip_smoke.py does.
"""

import subprocess
import sys

CODE = ("import sys; sys.path[:0] = ['.', 'tests']; import chip_smoke as cs; "
        "cs.phase_build(); from test_torch_vardct_streams import encode_xyb_vardct; "
        "st = [(f'vardct_{w}x{h}', encode_xyb_vardct(w, h, seed=s)[0], 'vardct', (w, h), 1) "
        "for w, h, s in ((256, 256, 41), (512, 512, 42))]; cs.phase_host_route(st)")


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    first, second = sys.argv[1:]
    rc = 0
    for root in (first, second, second, first):
        out = subprocess.run([sys.executable, "-c", CODE], cwd=root, capture_output=True,
                             text=True, timeout=600)
        summary = [ln for ln in out.stdout.splitlines() if '"summary"' in ln]
        print(root, out.returncode, summary[-1] if summary else out.stderr[-1500:], flush=True)
        rc = rc or out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
