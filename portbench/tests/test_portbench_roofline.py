"""The benchmark's roofline arithmetic (portbench/metrics/): K1's bound
reproduces the one the repository's chip script printed, and K3's count
comes from what the writer wrote, whatever decodes it.

    python3 -m pytest portbench/tests -q
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.writers import xyb_vardct  # noqa: E402

VARDCT = run.load_json(os.path.join(run.BENCH, "configs", "vardct_d1.json"))["writer_options"]


def test_k1_bound_at_4k_with_gaborish_and_two_epf_steps():
    k1 = run.load_reader("k1_roofline_share")
    # chip_smoke.py's epf_gab_bound_ms(2160, 3840, True, 2): 0.0693 ms, bytes-bound
    assert round(k1.bound_s(2160, 3840) * 1e3, 4) == 0.0693
    assert k1.epf_gab_ops_per_px(True, 2) == 33 + (4 * 51 + 2 + 27) + (4 * 15 + 2 + 27)
    assert k1.epf_gab_ops_per_px(True, 3) > k1.epf_gab_ops_per_px(True, 2)


def _toc_sizes(data: bytes, n_sections: int) -> list:
    """The section sizes of the writer's TOC, read back from its bytes
    (U32 of selectors bits 10, 14 + 1024, 22 + 17408, 30 + 4211712): the
    last n_sections entries before the TOC's byte alignment."""
    bits = "".join(f"{b:08b}"[::-1] for b in data)
    opts = ((10, 0), (14, 1024), (22, 17408), (30, 4211712))
    # the TOC ends where the sections begin: sum(sizes) bytes before the end
    for start in range(min(len(bits) - 2, 8192)):
        pos, sizes = start, []
        for _ in range(n_sections):
            sel = int(bits[pos : pos + 2][::-1], 2)
            nb, off = opts[sel]
            sizes.append(int(bits[pos + 2 : pos + 2 + nb][::-1], 2) + off)
            pos += 2 + nb
        end = -(-pos // 8)
        if end + sum(sizes) == len(data):
            return sizes
    raise AssertionError("no TOC found")


@pytest.mark.parametrize("size", [(520, 520), (768, 512)])
def test_k3_count_is_the_writers_streams(size):
    k3 = run.load_reader("k3_roofline_share")
    data, coded = xyb_vardct.write(*size, 2**40 + 3, **VARDCT)
    groups = coded["groups"]
    lf_groups = 1
    n_sections = 1 + lf_groups + 1 + groups
    sizes = _toc_sizes(data, n_sections)
    # the AC sections' bytes are the HF groups' sections as the stream's TOC has them
    assert coded["ac_section_bytes"] == sum(sizes[-groups:])
    nbytes, ops = k3.count(coded)
    # the coefficients out: the frame's blocks, not whole groups
    bh, bw = -(-size[1] // 8), -(-size[0] // 8)
    assert coded["transform"].shape == (bh, bw)
    assert nbytes == (sum(sizes[-groups:]) + 64 * 256 * 8 + (16 * 495 + 16)
                      + 3 * (8 * bh) * (8 * bw) * 4)
    assert 3 * (8 * bh) * (8 * bw) * 4 <= groups * 3 * 256 * 256 * 4
    assert ops == coded["ac_tokens"] * k3.OPS_PER_TOKEN
    # the count reads nothing but the writer's record
    assert k3.bound_s(dict(coded)) == k3.bound_s({k: coded[k] for k in (
        "ac_section_bytes", "ac_clusters", "ac_log_alpha", "ac_contexts", "transform",
        "ac_tokens")})


def test_k3_tokens_are_one_a_coded_coefficient_and_one_an_item():
    data, coded = xyb_vardct.write(520, 520, 5, **VARDCT)
    tmap = coded["transform"]
    items = 3 * int((tmap >= 128).sum())
    # each item codes its nonzero count, then its positions up to the last
    # coded one: at least one token an item, more with coefficients
    assert coded["ac_tokens"] >= items + int((coded["coeffs"] != 0).sum())
