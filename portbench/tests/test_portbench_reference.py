"""The benchmark's plain reference (portbench/reference/) against two
decoders on small streams of the configuration: the port's CPU decode,
and the JAX package's, a witness that shares no code with the port's
plain stages of which the reference keeps copies (colour, transfer
curve, dither, gaborish, EPF, dequant weights); what the benchmark's
modules import; and a run without a card.

    python3 -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.reference import xyb_vardct as ref_vardct  # noqa: E402
from portbench.writers import xyb_vardct  # noqa: E402

BENCH = pathlib.Path(run.BENCH)
VARDCT = run.load_json(BENCH / "configs" / "vardct_d1.json")["writer_options"]
STREAMS = [((520, 520), 3, VARDCT), ((512, 384), 2**40 + 5, VARDCT), ((600, 300), 9, {})]


def _port_u8(data):
    import jxl_tpu_torch

    return jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu").frames[0]


@pytest.mark.parametrize("size, seed, kw", STREAMS)
def test_vardct_reference_matches_the_ports_cpu_decode(monkeypatch, size, seed, kw):
    # the native host AC decoder: the plain lane decoder steps in Python
    monkeypatch.setenv("JXL_TPU_AC", "host")
    data, coded = xyb_vardct.write(*size, seed, **kw)
    got = _port_u8(data)
    ref = ref_vardct.render(coded, *size, "cpu")
    worst, off = run.compare(torch, got, ref)
    # float32 rounding apart: a sample in a million may round to the other step
    assert worst < 1e-3 and off / ref.numel() < 1e-5, (worst, off)


def _jax_package_u8(data):
    """The JAX package's u8 decode on the CPU, as the repository's tests
    run it."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JXL_TPU_JIT_CACHE"] = "off"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from jxl_tpu.api.simple import decode_image

    return torch.from_numpy(np.asarray(decode_image(data, pixel_format="u8").frames[0]))


@pytest.mark.parametrize("size, seed, kw", STREAMS)
def test_vardct_reference_matches_the_jax_packages_cpu_decode(size, seed, kw):
    data, coded = xyb_vardct.write(*size, seed, **kw)
    got = _jax_package_u8(data)
    ref = ref_vardct.render(coded, *size, "cpu")
    assert tuple(got.shape) == tuple(ref.shape)
    worst, off = run.compare(torch, got, ref)
    # XLA's float32 rounds 2-5 samples in 100,000 to the other step; the
    # cell's own limits hold with room
    limits = run.load_json(BENCH / "workloads" / "vardct_d1.photo_4k.json")["check"]["limits"]
    assert worst < 1e-3 <= limits["excess_lsb"], worst
    assert 100.0 * off / ref.numel() < limits["off_share_pct"] / 2, off


def _imports(path: pathlib.Path) -> set:
    """Top-level names of the modules a file imports, relative imports
    resolved inside portbench."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("portbench" if node.level else node.module.split(".")[0])
    return names


@pytest.mark.parametrize("part, banned", [
    ("run.py", {"jax", "jaxlib", "flax", "jxl_tpu"}),
    ("trace.py", {"jax", "jaxlib", "flax", "jxl_tpu"}),
    ("metrics", {"jax", "jaxlib", "flax", "jxl_tpu", "jxl_tpu_torch"}),
    ("writers", {"jax", "jaxlib", "flax", "jxl_tpu", "jxl_tpu_torch"}),
    ("reference", {"jax", "jaxlib", "flax", "jxl_tpu", "jxl_tpu_torch"}),
])
def test_benchmark_sources_import_neither_jax_nor_the_jax_package(part, banned):
    root = BENCH / part
    files = [root] if root.is_file() else sorted(root.glob("*.py"))
    for f in files:
        assert not _imports(f) & banned, (f, _imports(f) & banned)


def test_reference_loads_nothing_of_the_decoder():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.xyb_vardct, "
            "portbench.trace; print(' '.join(sorted("
            "{m.split('.')[0] for m in sys.modules})))" % ROOT)
    mods = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True).stdout.split()
    assert not {"jax", "jaxlib", "flax", "jxl_tpu", "jxl_tpu_torch"} & set(mods)


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"), "--workload",
                        "vardct_d1.photo_4k", "--seed", str(2**40), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
