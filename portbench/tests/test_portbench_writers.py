"""The benchmark's frozen writer writes the bytes of the repository's test
writer (tests/test_torch_vardct_streams.py) for the options the
configuration uses, and imports nothing of the decoder. The test may
import the test writer; a run never does.

    python3 -m pytest portbench/tests -q
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.writers import xyb_vardct  # noqa: E402

VARDCT = run.load_json(os.path.join(run.BENCH, "configs", "vardct_d1.json"))["writer_options"]


def _test_writer():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_vardct_streams

    return test_torch_vardct_streams


@pytest.mark.parametrize("size, seed, kw", [
    ((520, 520), 3, VARDCT),
    ((512, 384), 2**40 + 5, VARDCT),
    ((384, 384), 11, dict(VARDCT, dequant="params")),
    ((600, 300), 5, {}),
    ((300, 600), 7, {"transforms": "dct8", "filters": False}),
])
def test_vardct_writer_writes_the_test_writers_bytes(size, seed, kw):
    tv = _test_writer()
    want, coeffs = tv.encode_xyb_vardct(*size, seed=seed, **kw)
    got, coded = xyb_vardct.write(*size, seed, **kw)
    assert got == want
    assert np.array_equal(coded["coeffs"], coeffs)


def test_writer_imports_nothing_of_the_decoder():
    code = ("import sys; sys.path.insert(0, %r); import portbench.writers.xyb_vardct; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))" % ROOT)
    mods = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True).stdout.split()
    assert not {"jax", "jaxlib", "jxl_tpu", "jxl_tpu_torch", "torch"} & set(mods)
