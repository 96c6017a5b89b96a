"""The lossless configuration (modular_d0) and its cell on the CPU: the
frozen writer's codestream byte for byte the test writer's; the plain
reference (reference/rgb_lossless.py) equals the source pixels, and its
int32 control fails a limit; a run of the cell at a small size is
correct, and with a fault planted under the timed path not correct; the
reference and the writer import nothing of the decoder.

    python3 -m pytest portbench/tests/test_portbench_lossless.py -q
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.reference import rgb_lossless as reference  # noqa: E402
from portbench.writers import rgb_lossless as writer  # noqa: E402

CELL_NAME = "modular_d0.photo_4k"
CELL = run.load_json(os.path.join(run.BENCH, "workloads", f"{CELL_NAME}.json"))
CONFIG = run.load_json(os.path.join(run.BENCH, "configs", f"{CELL['config']}.json"))
LIMITS = CELL["check"]["limits"]


def _test_writer():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_lossless_streams

    return test_torch_lossless_streams


@pytest.mark.parametrize("size, seed", [((600, 520), 3), ((1000, 700), 2**40 + 5),
                                        ((256, 256), 3_000_000_017)])
def test_writer_writes_the_test_writers_codestream(size, seed):
    want, want_coded = _test_writer().encode_rgb_lossless(*size, seed=seed)
    data, coded = writer.write(*size, seed, **CONFIG["writer_options"])
    assert data == want
    assert np.array_equal(coded["residuals"], want_coded["residuals"])
    assert np.array_equal(coded["rct"], want_coded["rct"])


@pytest.mark.parametrize("seed", [2**40 + 201, 2**40 + 202])
def test_reference_gives_the_source_and_its_control_fails(seed):
    """The reference rebuilds the source pixels exactly, so the limits are
    0.0 and 0.0; computed in int32 (the weighted predictor's products
    wrap) it fails them."""
    _, coded = writer.write(520, 300, seed)
    ref = reference.render(coded, 520, 300, "cpu")
    assert np.array_equal(ref.numpy(), coded["pixels"])
    ctl = reference.render(coded, 520, 300, "cpu", precision=CONFIG["control"])
    m, k = run.compare(torch, torch.round(ctl).clamp(0, 255).to(torch.uint8), ref)
    got = {"excess_lsb": m, "off_share_pct": 100.0 * k / ref.numel()}
    assert any(got[key] > lim for key, lim in LIMITS.items()), got


def _residual_off_by_one(monkeypatch, state):
    """One sample of a decode's first group stream one off after the
    native decode, before the group's inverse RCT."""
    from jxl_tpu_torch import native

    real, lock = native.decode_modular_native, threading.Lock()

    def broken(buffers, *a, **kw):
        ok = real(buffers, *a, **kw)
        with lock:
            if state["armed"] and not state["planted"] and buffers and buffers[0].data.size:
                state["planted"] = True
                buffers[0].data[3, 5] += 1
        return ok

    monkeypatch.setattr(native, "decode_modular_native", broken)


def _rct_op_swapped(monkeypatch, state):
    """A decode's first inverse RCT with the next type."""
    from dataclasses import replace

    from jxl_tpu_torch.modular import transforms

    real, lock = transforms.apply_rct, threading.Lock()

    def broken(storage, step):
        with lock:
            plant = state["armed"] and not state["planted"]
            state["planted"] = state["planted"] or plant
        return real(storage, replace(step, op=(step.op + 1) % 7) if plant else step)

    monkeypatch.setattr(transforms, "apply_rct", broken)


def _wp_update_skipped(monkeypatch, state):
    """The host decoder (the native one refused) with the weighted
    predictor's error update skipped: the tree's property 15 and the
    predictions go wrong, and with them the stream's contexts."""
    from jxl_tpu_torch import native
    from jxl_tpu_torch.modular import predict

    real_decode, real_update = (native.decode_modular_native,
                                predict.WeightedPredictorState.update_errors)
    monkeypatch.setattr(native, "decode_modular_native", lambda *a, **kw: (
        False if state["armed"] else real_decode(*a, **kw)))
    monkeypatch.setattr(predict.WeightedPredictorState, "update_errors",
                        lambda self, *a: None if state["armed"] else real_update(self, *a))


FAULTS = {"sound": None, "residual_off_by_one": _residual_off_by_one,
          "rct_op_swapped": _rct_op_swapped, "wp_update_skipped": _wp_update_skipped}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, fault):
    """The fault is planted in the window's decodes (not the warm ones):
    a decode that then fails counts, one that gives wrong pixels is
    caught by the comparison."""
    import jxl_tpu_torch

    # the run's own check for JAX modules, blind to those that another
    # test in this process loaded
    loaded = {m.split(".")[0] for m in sys.modules}
    monkeypatch.setattr(run, "forbidden_modules", lambda: sorted(
        ({m.split(".")[0] for m in sys.modules} - loaded) & set(run.FORBIDDEN)))
    state = {"calls": 0, "armed": False, "planted": False}
    real = jxl_tpu_torch.decode_image

    def decode(*a, **kw):
        state["calls"] += 1
        state["armed"] = state["calls"] > run.WARM_DECODES
        state["planted"] = False
        return real(*a, **kw)

    monkeypatch.setattr(jxl_tpu_torch, "decode_image", decode)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch, state)
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    # every decode of the window compared, on two files of one size (the
    # host decoder steps in Python: a smaller frame of two groups)
    size = [264, 72] if fault == "wp_update_skipped" else [520, 300]
    cell = dict(CELL, sizes=[size], pool=2, check=dict(CELL["check"], sample_share=1.0))
    torch.set_num_threads(2)
    res = run.run_cell(bench, CELL_NAME, cell, CONFIG, 2**40 + 79, 4.0, False, "cpu")
    assert res["attempted"] >= 2 and res["check"]["frames_compared"] + res["failed"] >= 2
    assert res["correct"] is (fault == "sound"), res["check"]


@pytest.mark.parametrize("module", ["portbench.reference.rgb_lossless",
                                    "portbench.writers.rgb_lossless"])
def test_imports_nothing_of_the_decoder(module):
    code = ("import sys; sys.path.insert(0, %r); import %s; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))" % (ROOT, module))
    mods = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True).stdout.split()
    assert not {"jax", "jaxlib", "jxl_tpu", "jxl_tpu_torch"} & set(mods)
