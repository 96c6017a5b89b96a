"""A run of each cell of BENCHMARK.json with the timed path broken
underneath comes out not correct. The run skips the harness's look for a card and decodes on the
CPU at a small size (run.run_cell with device="cpu"); jxl_tpu_torch's
decode_image is wrapped to plant one fault a case: a sample altered where
the frame is produced, the first call's frame returned by every call, as
if the decoder's state never changed, or half of the frame's rows left
out.

    python3 -m pytest portbench/tests -q
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402

# (cell, a small size of its configuration)
CELLS = (("vardct_d1.photo_4k", [512, 384]),)


def _altered(frames, first):
    f = frames[0].clone()
    h, w, _ = f.shape
    f[h // 2, w // 2, 1] += 16
    return [f]


def _stale(frames, first):
    return first[0] if first else frames


def _half_left_out(frames, first):
    f = frames[0].clone()
    f[f.shape[0] // 2 :] = 0
    return [f]


def _sound(frames, first):
    return frames


FAULTS = {"sound": _sound, "altered": _altered, "state_unchanged": _stale,
          "half_left_out": _half_left_out}


def _run(monkeypatch, cell_name, size, fault):
    import jxl_tpu_torch

    monkeypatch.setenv("JXL_TPU_AC", "host")
    real = jxl_tpu_torch.decode_image
    first = []

    def broken(data, **kw):
        img = real(data, **kw)
        frames = FAULTS[fault](img.frames, first)
        first[:] = first or [img.frames]
        img.frames = frames
        return img

    monkeypatch.setattr(jxl_tpu_torch, "decode_image", broken)
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = run.load_json(os.path.join(run.BENCH, "workloads", f"{cell_name}.json"))
    # every decode of the window compared, on two files of one size
    cell = dict(cell, sizes=[size], pool=2, check=dict(cell["check"], sample_share=1.0))
    config = run.load_json(os.path.join(run.BENCH, "configs", f"{cell['config']}.json"))
    torch.set_num_threads(2)
    return run.run_cell(bench, cell_name, cell, config, 2**40 + 77, 5.0, False, "cpu")


@pytest.mark.parametrize("cell_name, size", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell_name, size, fault):
    res = _run(monkeypatch, cell_name, size, fault)
    assert res["attempted"] >= 2 and res["check"]["frames_compared"] >= 2
    assert res["correct"] is (fault == "sound"), res["check"]
