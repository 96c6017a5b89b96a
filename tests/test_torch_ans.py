"""The port's rANS lane decode (ops/device_ans.py, ops/ans_lanes.py)
against jxl_tpu's XLA and Pallas versions on the same numpy inputs: tokens
and final states bit for bit. The Pallas kernel runs in interpret mode, as
tests/test_pallas_ans.py runs it on the CPU.
"""

import numpy as np
import pytest
import torch

from jxl_tpu.entropy.hybrid_uint import HybridUint
from jxl_tpu.ops.device_ans import ans_decode_batch as jax_ans_decode_batch
from jxl_tpu.ops.device_ans import ans_read_uint_batch as jax_ans_read_uint_batch
from jxl_tpu.ops.device_ans import pack_clustered_tables, pack_table, pack_uint_configs
from jxl_tpu.ops.pallas_ans import ans_decode_batch_pallas

from jxl_tpu_torch.ops import ans_lanes, device_ans
from test_device_ans import FINAL_STATE, LOG_BUCKET, ans_encode, encode_uint_stream, make_hist, random_dist


def _streams(rng, h, nsyms, n_streams, n_tokens, slack=4):
    probs = np.array(h.dist[:nsyms], dtype=np.float64)
    probs /= probs.sum()
    datas, expected = [], []
    for _ in range(n_streams):
        syms = rng.choice(nsyms, size=n_tokens, p=probs).tolist()
        datas.append(ans_encode(syms, h))
        expected.append(syms)
    buf = np.zeros((n_streams, max(map(len, datas)) + slack), dtype=np.uint8)
    for i, d in enumerate(datas):
        buf[i, : len(d)] = np.frombuffer(d, np.uint8)
    return buf, np.array(expected)


@pytest.mark.parametrize("n_streams,n_tokens,seed", [(16, 200, 3), (7, 150, 4)])
def test_plain_ans_decode_matches_jxl_tpu(n_streams, n_tokens, seed):
    rng = np.random.default_rng(seed)
    h = make_hist(random_dist(rng, 48))
    buf, expected = _streams(rng, h, 48, n_streams, n_tokens)
    table = pack_table(h)
    ref_toks, ref_final = jax_ans_decode_batch(buf, table, LOG_BUCKET, n_tokens)
    pal_toks, pal_final = ans_decode_batch_pallas(buf, table, LOG_BUCKET, n_tokens, interpret=True)
    toks, final = device_ans.ans_decode_batch(
        torch.from_numpy(buf), torch.from_numpy(device_ans.pack_table(h)), LOG_BUCKET, n_tokens)
    assert toks.dtype == torch.int32 and toks.shape == (n_streams, n_tokens)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(pal_toks))
    np.testing.assert_array_equal(toks.numpy(), expected)
    np.testing.assert_array_equal(final.numpy(), np.asarray(ref_final).astype(np.int64))
    np.testing.assert_array_equal(final.numpy(), np.asarray(pal_final).astype(np.int64))
    assert (final.numpy() == FINAL_STATE).all()


def test_plain_ans_decode_past_the_end_matches_jxl_tpu():
    """More tokens than were encoded: cursors run past the rows' ends and
    both versions re-read the last byte of each row."""
    rng = np.random.default_rng(9)
    h = make_hist(random_dist(rng, 30))
    buf, _ = _streams(rng, h, 30, 5, 40, slack=0)
    ref_toks, ref_final = jax_ans_decode_batch(buf, pack_table(h), LOG_BUCKET, 120)
    toks, final = device_ans.ans_decode_batch(
        torch.from_numpy(buf), torch.from_numpy(pack_table(h)), LOG_BUCKET, 120)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(final.numpy(), np.asarray(ref_final).astype(np.int64))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    h = make_hist(random_dist(rng, 20))
    buf, expected = _streams(rng, h, 20, 3, 50)
    before = ans_lanes.ans_decode_batch.launches
    toks, final = ans_lanes.ans_decode_batch(
        torch.from_numpy(buf), torch.from_numpy(pack_table(h)), LOG_BUCKET, 50)
    assert ans_lanes.ans_decode_batch.launches == before
    np.testing.assert_array_equal(toks.numpy(), expected)
    assert (final.numpy() == FINAL_STATE).all()
    with pytest.raises(ValueError):
        ans_lanes.ans_decode_batch(torch.from_numpy(buf).int(), torch.from_numpy(pack_table(h)),
                                   LOG_BUCKET, 50)
    with pytest.raises(ValueError):
        ans_lanes.ans_decode_batch(torch.from_numpy(buf), torch.from_numpy(pack_table(h)), 3, 50)


def test_plain_read_uint_matches_jxl_tpu():
    rng = np.random.default_rng(7)
    hists = [make_hist(random_dist(rng, 64)) for _ in range(3)]
    cfgs = [HybridUint(4, 2, 0), HybridUint(4, 1, 1), HybridUint(6, 2, 1)]
    n_streams, n_tokens = 12, 80
    bufs, clusters_all, expected = [], [], []
    for _ in range(n_streams):
        clusters = rng.integers(0, 3, n_tokens).tolist()
        vals = []
        for c in clusters:
            cfg = cfgs[c]
            while True:  # a value whose token has probability in its cluster
                v = int(rng.integers(0, 4000))
                if v < cfg.split_token:
                    tok = v
                else:
                    n = v.bit_length() - 1
                    nb = n - cfg.msb_in_token - cfg.lsb_in_token
                    msb_bits = (v >> (cfg.lsb_in_token + nb)) & ((1 << cfg.msb_in_token) - 1)
                    tok = cfg.split_token + (
                        ((n - cfg.split_exponent) << (cfg.msb_in_token + cfg.lsb_in_token))
                        | (msb_bits << cfg.lsb_in_token) | (v & ((1 << cfg.lsb_in_token) - 1)))
                if tok < 64 and hists[c].dist[tok] > 0:
                    break
            vals.append(v)
        bufs.append(encode_uint_stream(vals, clusters, hists, cfgs))
        clusters_all.append(clusters)
        expected.append(vals)
    buf = np.zeros((n_streams, max(map(len, bufs)) + 6), dtype=np.uint8)
    for i, d in enumerate(bufs):
        buf[i, : len(d)] = np.frombuffer(d, np.uint8)
    args = (pack_clustered_tables(hists), pack_uint_configs(cfgs),
            np.array(clusters_all, dtype=np.int32))
    ref_vals, ref_final = jax_ans_read_uint_batch(buf, *args, LOG_BUCKET, n_tokens)
    vals, final = device_ans.ans_read_uint_batch(
        torch.from_numpy(buf), *(torch.from_numpy(a) for a in args), LOG_BUCKET, n_tokens)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals).astype(np.int64))
    np.testing.assert_array_equal(vals.numpy(), np.array(expected))
    np.testing.assert_array_equal(final.numpy(), np.asarray(ref_final).astype(np.int64))
    assert (final.numpy() == FINAL_STATE).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_streams", [135, 37])
def test_kernel_matches_plain_on_the_card(cuda_device, n_streams):
    rng = np.random.default_rng(11)
    h = make_hist(random_dist(rng, 64))
    buf, expected = _streams(rng, h, 64, n_streams, 300)
    st = torch.from_numpy(buf).to(cuda_device)
    tb = torch.from_numpy(pack_table(h)).to(cuda_device)
    before = ans_lanes.ans_decode_batch.launches
    toks, final = ans_lanes.ans_decode_batch(st, tb, LOG_BUCKET, 300)
    torch.cuda.synchronize()
    assert ans_lanes.ans_decode_batch.launches == before + 1
    want_toks, want_final = device_ans.ans_decode_batch(st, tb, LOG_BUCKET, 300)
    assert torch.equal(toks, want_toks) and torch.equal(final, want_final)
    np.testing.assert_array_equal(toks.cpu().numpy(), expected)
