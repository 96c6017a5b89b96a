"""The port's colour math (XYB -> linear, transfer functions, f32 -> u8)
against the JAX package's numpy and jax.numpy paths on seeded planes.

float32 results agree within 1e-6 (pow may differ by an ulp between
libraries); u8 within 1 LSB (a value on a rounding edge may land either
side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jxl_tpu.color import tf as np_tf
from jxl_tpu.color import xyb as np_xyb
from jxl_tpu.io.headers.image import _default_opsin_inverse_matrix
from jxl_tpu.render.stages import core as np_core
from jxl_tpu_torch.color import tf as t_tf
from jxl_tpu_torch.color import xyb as t_xyb
from jxl_tpu_torch.render.stages import core as t_core


def _xyb(seed, h=64, w=96):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.01, size=(h, w)).astype(np.float32)
    y = rng.uniform(0.1, 0.85, size=(h, w)).astype(np.float32)
    b = (y + rng.normal(0.0, 0.05, size=(h, w))).astype(np.float32)
    return x, y, b


def _port_xyb_to_srgb(x, y, b, opsin):
    r, g, bl = t_xyb.xyb_to_linear(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(b), opsin, 255.0
    )
    return [t_tf.linear_to_srgb(c).numpy() for c in (r, g, bl)]


@pytest.mark.parametrize("xp", [np, jnp], ids=["np", "jnp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_xyb_to_srgb_matches(xp, seed):
    opsin = _default_opsin_inverse_matrix()
    x, y, b = _xyb(seed)
    lin = np_xyb.xyb_to_linear(xp.asarray(x), xp.asarray(y), xp.asarray(b), opsin, 255.0, xp)
    want = [np.asarray(np_tf.linear_to_srgb(c, xp)) for c in lin]
    got = _port_xyb_to_srgb(x, y, b, opsin)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-6


@pytest.mark.parametrize("xp", [np, jnp], ids=["np", "jnp"])
def test_linear_matches(xp):
    opsin = _default_opsin_inverse_matrix()
    x, y, b = _xyb(2)
    want = np_xyb.xyb_to_linear(xp.asarray(x), xp.asarray(y), xp.asarray(b), opsin, 255.0, xp)
    got = t_xyb.xyb_to_linear(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(b), opsin, 255.0
    )
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6


@pytest.mark.parametrize(
    "name,args",
    [("linear_to_srgb", ()), ("linear_to_bt709", ()), ("linear_to_gamma", (1 / 2.2,)),
     ("linear_to_pq", (1000.0,)), ("scene_to_hlg", ()), ("srgb_to_linear", ()),
     ("pq_to_linear", (1000.0,)), ("hlg_to_scene", ())],
)
def test_transfer_functions_match_numpy(name, args):
    v = np.random.default_rng(3).uniform(-0.2, 1.2, size=(50, 60)).astype(np.float32)
    want = getattr(np_tf, name)(v, *args)
    got = getattr(t_tf, name)(torch.from_numpy(v), *args).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("xp", [np, jnp], ids=["np", "jnp"])
@pytest.mark.parametrize("channel", [0, 1, 2])
def test_f32_to_u8_matches(xp, channel):
    v = np.random.default_rng(4 + channel).uniform(-0.1, 1.1, size=(70, 90)).astype(np.float32)
    want = np.asarray(np_core.f32_to_u8(xp, xp.asarray(v), 8, channel))
    got = t_core.f32_to_u8(torch.from_numpy(v), 8, channel).numpy()
    assert got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("fmt", ["u16", "f16"])
def test_other_output_formats_match(fmt):
    v = np.random.default_rng(5).uniform(-0.1, 1.1, size=(30, 40)).astype(np.float32)
    want = np_core.convert_output(np, v, fmt)
    got = t_core.convert_output(torch.from_numpy(v), fmt).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_dither_table_is_byte_equal():
    assert t_core.dither_table().tobytes() == np_core.dither_table().tobytes()
