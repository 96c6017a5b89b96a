"""ops/device_render.py of jxl_tpu_torch on the CPU, against
jxl_tpu/ops/device_render.py on the same seeded inputs: render_block
(K1's plain version, then the colour math), jit_render, idct8_batch and
dequant_cfl_idct8.

Tolerance: f32 max abs 1e-5, the K1 twin tolerance of
tests/test_pallas_epf.py (the port's stage math and K1 round a few
samples apart from jxl_tpu's jnp stage math). K1 itself runs only on the
card: test_render_block_on_the_card skips here (chip_smoke.py's sharded
phase runs it there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jxl_tpu.ops import device_render as ref
from jxl_tpu_torch.ops import device_render as DR

TOL = 1e-5


def _inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    planes = np.stack([rng.uniform(-0.03, 0.03, (h, w)), rng.uniform(0.0, 0.9, (h, w)),
                       rng.uniform(0.0, 0.9, (h, w))]).astype(np.float32)
    sigma = rng.uniform(0.05, 0.8, (-(-h // 8) + 4, -(-w // 8) + 4)).astype(np.float32)
    sigma[::3, ::5] = 0.0  # passthrough blocks
    return planes, sigma


PARAMS = {
    "default": {},
    "no_gaborish": dict(gab=False),
    "epf3": dict(epf_iters=3),
    "epf1": dict(epf_iters=1),
    "gaborish_only": dict(epf_iters=0),
    "bright": dict(intensity_target=1000.0, gab_weights=((0.1, 0.05),) * 3),
}


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("pos", [(0, 0), (8, 16)])
def test_render_block_matches_jxl_tpu(name, pos):
    planes, sigma = _inputs(40, 56, seed=len(name) + pos[0])
    p_ref = ref.RenderParams(**PARAMS[name])
    p_port = DR.RenderParams(**PARAMS[name])
    want = np.asarray(ref.render_block(jnp.asarray(planes), jnp.asarray(sigma), p_ref, pos=pos))
    got = DR.render_block(torch.from_numpy(planes), torch.from_numpy(sigma), p_port, pos=pos)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL


def test_render_block_takes_ragged_sizes():
    planes, sigma = _inputs(13, 21, seed=7)
    want = np.asarray(ref.render_block(jnp.asarray(planes), jnp.asarray(sigma),
                                       ref.RenderParams()))
    got = DR.render_block(torch.from_numpy(planes), torch.from_numpy(sigma), DR.RenderParams())
    assert np.abs(got.numpy() - want).max() <= TOL


def test_jit_render_is_render_block():
    planes, sigma = _inputs(32, 32, seed=3)
    p = DR.RenderParams()
    a = DR.jit_render(p)(torch.from_numpy(planes), torch.from_numpy(sigma))
    b = DR.render_block(torch.from_numpy(planes), torch.from_numpy(sigma), p)
    assert torch.equal(a, b)


@pytest.mark.parametrize("pos", [(4, 0), (0, 9)])
def test_render_block_refuses_an_off_grid_phase(pos):
    planes, sigma = _inputs(16, 16, seed=1)
    with pytest.raises(ValueError):
        DR.render_block(torch.from_numpy(planes), torch.from_numpy(sigma), DR.RenderParams(),
                        pos=pos)


@pytest.mark.parametrize("n", [1, 7, 64])
def test_idct8_batch_matches_jxl_tpu(n):
    rng = np.random.default_rng(n)
    coeffs = rng.normal(0.0, 1.0, (n, 8, 8)).astype(np.float32)
    want = np.asarray(ref.idct8_batch(jnp.asarray(coeffs)))
    got = DR.idct8_batch(torch.from_numpy(coeffs))
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("n", [1, 5, 33])
def test_dequant_cfl_idct8_matches_jxl_tpu(n):
    rng = np.random.default_rng(100 + n)
    q = rng.integers(-6, 7, (n, 3, 64)).astype(np.int32)
    q[:, :, 20:] *= rng.random((n, 3, 44)) < 0.3  # mostly zero high frequencies
    mats = rng.uniform(0.001, 0.05, (3, 64)).astype(np.float32)
    x_cc = rng.normal(0.0, 0.1, n).astype(np.float32)
    b_cc = rng.normal(1.0, 0.1, n).astype(np.float32)
    lf = rng.normal(0.0, 0.3, (n, 3)).astype(np.float32)
    biases = (0.145, 0.145, 0.145, 0.56)
    scale_y, x_mul, b_mul = 0.37, 0.8, 1.25
    want = np.asarray(ref.dequant_cfl_idct8(jnp.asarray(q), jnp.asarray(mats), scale_y, x_mul,
                                            b_mul, jnp.asarray(x_cc), jnp.asarray(b_cc),
                                            biases, jnp.asarray(lf)))
    got = DR.dequant_cfl_idct8(torch.from_numpy(q), torch.from_numpy(mats), scale_y, x_mul,
                               b_mul, torch.from_numpy(x_cc), torch.from_numpy(b_cc), biases,
                               torch.from_numpy(lf))
    assert tuple(got.shape) == want.shape == (n, 3, 8, 8)
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (K1 runs only there)")


@pytest.mark.cuda
def test_render_block_on_the_card(card):
    planes, sigma = _inputs(272, 3840, seed=5)
    p = DR.RenderParams()
    want = DR.render_block(torch.from_numpy(planes), torch.from_numpy(sigma), p)
    got = DR.render_block(torch.from_numpy(planes).cuda(), torch.from_numpy(sigma).cuda(), p)
    assert (got.cpu() - want).abs().max() <= TOL
