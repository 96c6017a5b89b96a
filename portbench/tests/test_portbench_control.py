"""The control of the benchmark's comparison, on the card at each cell's own
size: the plain reference put in the decoder's place and computed in the
nearest precision below the one its configuration states (TF32 products
for the VarDCT configuration's float32 with TF32 off) must fail the
cell's limits on every seed. The readings print with -s.

    python3 -m pytest portbench/tests/test_portbench_control.py -q -s
"""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402

CELLS = ("vardct_d1.photo_4k",)
SEEDS = (2**40 + 101, 2**40 + 102, 2**40 + 103)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size there")
    return "cuda"


def control_readings(cell_name: str, seed: int, device: str) -> dict:
    """The comparison's numbers of the control against the reference, over
    the cell's pool of the run seeded `seed`."""
    import importlib

    import torch

    cell = run.load_json(os.path.join(run.BENCH, "workloads", f"{cell_name}.json"))
    config = run.load_json(os.path.join(run.BENCH, "configs", f"{cell['config']}.json"))
    ref_mod = importlib.import_module(f"portbench.reference.{config['reference']}")
    worst, off, total = 0.0, 0, 0
    for f in run.write_pool(config, cell, seed):
        ref = ref_mod.render(f.coded, f.width, f.height, device)
        ctl = ref_mod.render(f.coded, f.width, f.height, device, precision=config["control"])
        m, k = run.compare(torch, torch.round(ctl).to(torch.uint8), ref)
        worst, off, total = max(worst, m), off + k, total + ref.numel()
    return {"excess_lsb": worst, "off_share_pct": 100.0 * off / total}


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_the_cells_limits(card, cell_name):
    cell = run.load_json(os.path.join(run.BENCH, "workloads", f"{cell_name}.json"))
    limits = cell["check"]["limits"]
    for seed in SEEDS:
        got = control_readings(cell_name, seed, card)
        print(json.dumps({"cell": cell_name, "seed": seed, **got}))
        assert any(got[k] > lim for k, lim in limits.items()), (cell_name, seed, got)
