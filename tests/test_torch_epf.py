"""The port's gaborish + EPF (jxl_tpu_torch.ops.epf_gab) against the JAX
package's stage math (jxl_tpu.render.stages.core with numpy).

Same seeded inputs through both; the port runs the same operations in the
same order, so the tolerance is 1e-6 and bit equality is expected. The
CUDA kernel itself runs only on a card: its test is marked `cuda` and
skips here.
"""

import numpy as np
import pytest
import torch

from jxl_tpu.render.stages import core as np_core
from jxl_tpu_torch.ops import epf_gab as K

GAB = ((0.115169525, 0.061248592), (0.1, 0.05), (0.12, 0.07))
RF = dict(pass0_scale=0.9, pass2_scale=6.5, border_sad_mul=2.0 / 3.0,
          channel_scale=(40.0, 5.0, 3.5))


class _RF:
    epf_channel_scale = list(RF["channel_scale"])
    epf_pass0_sigma_scale = RF["pass0_scale"]
    epf_pass2_sigma_scale = RF["pass2_scale"]
    epf_border_sad_mul = RF["border_sad_mul"]


def _inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    planes = rng.normal(0.5, 0.2, size=(3, h, w)).astype(np.float32)
    sigma = rng.uniform(-3.0, -0.5, size=(h, w)).astype(np.float32)
    sigma[rng.random((h, w)) < 0.05] = -5.0  # below MIN_SIGMA: passthrough
    return planes, sigma


def _numpy_chain(planes, sigma, gab, iters):
    chans = [p for p in planes]
    if gab is not None:
        chans = [np_core.gaborish(np, c, w1, w2) for c, (w1, w2) in zip(chans, gab)]
    for step in [s for s, need in ((0, 3), (1, 1), (2, 2)) if iters >= need]:
        chans = np_core.epf_step_px(np, chans, sigma, _RF, step)
    return np.stack(chans)


def _args(planes, sigma, gab, iters):
    return (torch.from_numpy(planes), torch.from_numpy(sigma), gab, iters,
            RF["pass0_scale"], RF["pass2_scale"], RF["border_sad_mul"], RF["channel_scale"])


@pytest.mark.parametrize("size", [(150, 200), (77, 131)])
@pytest.mark.parametrize("iters", [0, 1, 2, 3])
@pytest.mark.parametrize("gab", [True, False])
def test_plain_epf_gab_matches_jxl_tpu_core(size, iters, gab):
    planes, sigma = _inputs(*size, seed=size[0] + 10 * iters + int(gab))
    g = GAB if gab else None
    want = _numpy_chain(planes, sigma, g, iters)
    got = K.epf_gab_reference(*_args(planes, sigma, g, iters)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def test_wrapper_takes_the_plain_version_on_cpu():
    planes, sigma = _inputs(40, 50, seed=1)
    args = _args(planes, sigma, GAB, 3)
    before = K.epf_gab.launches
    np.testing.assert_array_equal(K.epf_gab(*args).numpy(), K.epf_gab_reference(*args).numpy())
    assert K.epf_gab.launches == before  # no kernel launched for a CPU tensor


def test_mirror_repeats_the_edge_sample():
    from jxl_tpu_torch.render.stages import core

    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    for b in (1, 3, 5):
        want = np.pad(x.numpy(), b, mode="symmetric")
        np.testing.assert_array_equal(core._pad_mirror(x, b, b).numpy(), want)


@pytest.mark.parametrize(
    "bad",
    [
        lambda p, s: (p.double(), s),
        lambda p, s: (p[:2], s),
        lambda p, s: (p, s[:-1]),
    ],
)
def test_wrapper_rejects_bad_inputs(bad):
    planes, sigma = _inputs(20, 30, seed=2)
    p, s = bad(torch.from_numpy(planes), torch.from_numpy(sigma))
    with pytest.raises((TypeError, ValueError)):
        K.epf_gab(p, s, GAB, 2, **RF)


def test_kernel_params_match_the_plain_rounding():
    from jxl_tpu_torch.render.stages import core

    p = K._kernel_params(GAB, **RF)
    assert p.dtype == np.float32 and p.shape == (18,)
    assert tuple(p[3:6]) == core.gaborish_weights(*GAB[1])
    assert p[9 + 1] == np.float32(1.65)  # step 1 inside a block
    assert p[12 + 2] == np.float32(6.5 * 1.65 * (2.0 / 3.0))  # step 2 on a border


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison on the H100")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(150, 200), (77, 131), (5, 7), (1, 1), (2, 3), (3, 4097)])
def test_kernel_matches_plain_version_on_card(cuda_device, size):
    planes, sigma = _inputs(*size, seed=7)
    args = list(_args(planes, sigma, GAB, 3))
    args[0], args[1] = args[0].to(cuda_device), args[1].to(cuda_device)
    before = K.epf_gab.launches
    got = K.epf_gab(*args)
    assert K.epf_gab.launches == before + 1
    want = K.epf_gab_reference(*args)
    assert (got - want).abs().max().item() <= 1e-5
