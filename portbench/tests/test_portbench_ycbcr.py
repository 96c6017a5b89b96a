"""The recompressed-JPEG configuration (vardct_jpeg) and its cell on the
CPU: the port's decode against the plain reference
(reference/ycbcr_vardct.py) within the cell's limits at sizes with
partial groups and chroma edges past the last whole chroma block; the
frozen writer's codestream byte for byte the test writer's; a run of the
cell with a fault planted under the timed path comes out not correct;
the reference and the writer import nothing of the decoder. The TF32
control runs on the card only.

    python3 -m pytest portbench/tests/test_portbench_ycbcr.py -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.reference import dequant  # noqa: E402
from portbench.reference import ycbcr_vardct as reference  # noqa: E402
from portbench.writers import spec, ycbcr_vardct  # noqa: E402

CELL_NAME = "vardct_jpeg.photo_4k"
CELL = run.load_json(os.path.join(run.BENCH, "workloads", f"{CELL_NAME}.json"))
CONFIG = run.load_json(os.path.join(run.BENCH, "configs", f"{CELL['config']}.json"))
OPTIONS = CONFIG["writer_options"]
LIMITS = CELL["check"]["limits"]


def _readings(out, ref) -> dict:
    m, k = run.compare(torch, out, ref)
    return {"excess_lsb": m, "off_share_pct": 100.0 * k / ref.numel()}


@pytest.mark.parametrize("size, subsampling, seed", [
    ((520, 300), "420", 2**40 + 11),
    ((1000, 700), "420", 2**33 + 12),
    ((520, 300), "422", 13),  # 4:2:2 upsamples along the rows only
])
def test_port_matches_the_reference(monkeypatch, size, subsampling, seed):
    """The port's CPU decode and the reference compute the same float32
    steps in other orders (the inverse DCT as one product or two, the
    colour matrix's terms summed in another order), so a sample may land
    a few float32 steps from the reference's: past the half step only by
    that (excess_lsb) and rounding apart only where the reference lies
    within that of a midpoint (off_share_pct). The cell's limits hold it
    (the TF32 control fails them on the card)."""
    import jxl_tpu_torch

    monkeypatch.setenv("JXL_TPU_AC", "host")  # the AC's route is not what is compared
    data, coded = ycbcr_vardct.write(*size, seed, **dict(OPTIONS, subsampling=subsampling))
    img = jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu")
    ref = reference.render(coded, *size, "cpu")
    assert img.frames[0].shape == ref.shape == (size[1], size[0], 3)
    got = _readings(img.frames[0], ref)
    assert all(got[k] <= lim for k, lim in LIMITS.items()), got


def _test_writer():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_vardct_streams

    return test_torch_vardct_streams


def _boxes(data: bytes) -> list:
    out, pos = [], 0
    while pos < len(data):
        size = int.from_bytes(data[pos : pos + 4], "big")
        out.append((data[pos + 4 : pos + 8], data[pos + 8 : pos + size]))
        pos += size
    return out


@pytest.mark.parametrize("size, seed", [((520, 300), 3), ((1000, 700), 2**40 + 5),
                                        ((300, 520), 3_000_000_017)])
def test_writer_writes_the_test_writers_codestream(size, seed):
    tv = _test_writer()
    want, coeffs = tv.encode_ycbcr_vardct(*size, seed=seed, filters=False, **OPTIONS)
    data, coded = ycbcr_vardct.write(*size, seed, **OPTIONS)
    boxes = _boxes(data)
    assert [k for k, _ in boxes] == [b"JXL ", b"ftyp", b"jbrd", b"jxlc"]
    assert len(boxes[2][1]) == ycbcr_vardct.JBRD_BYTES
    assert boxes[3][1] == want
    assert np.array_equal(coded["coeffs"], coeffs)


def _swap_cb_cr(monkeypatch):
    from jxl_tpu_torch.render import simple

    real = simple.ycbcr_to_rgb
    monkeypatch.setattr(simple, "ycbcr_to_rgb", lambda y, cb, cr: real(y, cr, cb))


def _nearest_upsampling(monkeypatch):
    from jxl_tpu_torch.render.stages import core

    monkeypatch.setattr(core, "chroma_upsample_h", lambda p: p.repeat_interleave(2, 1))
    monkeypatch.setattr(core, "chroma_upsample_v", lambda p: p.repeat_interleave(2, 0))


def _library_tables(monkeypatch):
    from jxl_tpu_torch.vardct import device_frame

    monkeypatch.setattr(device_frame, "_matrices", lambda frame, t, nc: np.ascontiguousarray(
        dequant.library_table(spec.TABLE_FOR_TYPE[t])[:, :nc]))


FAULTS = {"sound": None, "cb_cr_swapped": _swap_cb_cr, "nearest_upsampling": _nearest_upsampling,
          "library_tables": _library_tables}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, fault):
    monkeypatch.setenv("JXL_TPU_AC", "host")
    # the run's own check for JAX modules, blind to those that another
    # test in this process loaded (test_portbench_reference.py decodes
    # with the JAX package)
    loaded = {m.split(".")[0] for m in sys.modules}
    monkeypatch.setattr(run, "forbidden_modules", lambda: sorted(
        ({m.split(".")[0] for m in sys.modules} - loaded) & set(run.FORBIDDEN)))
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    # every decode of the window compared, on two files of one size
    cell = dict(CELL, sizes=[[520, 300]], pool=2, check=dict(CELL["check"], sample_share=1.0))
    torch.set_num_threads(2)
    res = run.run_cell(bench, CELL_NAME, cell, CONFIG, 2**40 + 78, 4.0, False, "cpu")
    assert res["attempted"] >= 2 and res["check"]["frames_compared"] >= 2
    assert res["correct"] is (fault == "sound"), res["check"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size there")
    return "cuda"


@pytest.mark.cuda
def test_tf32_control_fails_a_limit(card):
    """The reference computed in TF32, the precision below the
    configuration's float32 (its transforms' operands rounded to TF32,
    reference/ycbcr_vardct.py), fails one of the cell's limits on each
    seed's pool. The readings print with -s."""
    for seed in (2**40 + 201, 2**40 + 202, 2**40 + 203):
        worst = {k: 0.0 for k in LIMITS}
        for f in run.write_pool(CONFIG, CELL, seed):
            ref = reference.render(f.coded, f.width, f.height, card)
            ctl = reference.render(f.coded, f.width, f.height, card, precision=CONFIG["control"])
            got = _readings(torch.round(ctl).to(torch.uint8), ref)
            worst = {k: max(worst[k], got[k]) for k in LIMITS}
        print(json.dumps({"cell": CELL_NAME, "seed": seed, **worst}))
        assert any(worst[k] > lim for k, lim in LIMITS.items()), (seed, worst)


@pytest.mark.parametrize("module", ["portbench.reference.ycbcr_vardct",
                                    "portbench.writers.ycbcr_vardct"])
def test_imports_nothing_of_the_decoder(module):
    code = ("import sys; sys.path.insert(0, %r); import %s; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))" % (ROOT, module))
    mods = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True).stdout.split()
    assert not {"jax", "jaxlib", "jxl_tpu", "jxl_tpu_torch"} & set(mods)
