"""K2, the batch rANS kernel (csrc/ans_lanes.cu, ops/ans_lanes.py), as far
as the CPU can check it: a numpy mirror of what the kernel computes (the
alias table expanded to one slot a 12-bit state in its prologue, the
halfword bit reader over a ring of the stream's bytes restaged between
chunks of 32 steps) against jxl_tpu's XLA twin and the port's plain
version on the same seeded inputs, tokens and final states bit for bit.
The kernel itself runs only on a card (the `cuda` test below;
chip_smoke.py holds it against the plain version there).
"""

import numpy as np
import pytest
import torch

from jxl_tpu.entropy.ans import SUM_PROBS, AnsHistogram
from jxl_tpu.ops.device_ans import ans_decode_batch as jax_ans_decode_batch
from jxl_tpu.ops.device_ans import pack_table

from jxl_tpu_torch.ops import ans_lanes, device_ans
from test_device_ans import LOG_BUCKET, make_hist, random_dist
from test_torch_ans import _streams
from test_torch_vardct_streams import random_int32_table

SLOTS = 4096
CHUNK = 32
MIN_RING_WORDS = 64


def alias_table(rng, log_bucket):
    """(5, NB) int32 alias table of a random distribution, as the
    reference's Vose alias construction lays it out, at any bucket size."""
    n = 1 << (12 - log_bucket)
    w = rng.integers(1, 100, n).astype(np.float64)
    d = np.floor(w / w.sum() * SUM_PROBS).astype(int)
    d[0] += SUM_PROBS - d.sum()
    h = AnsHistogram.__new__(AnsHistogram)
    h.dist = d.tolist()
    h._build_alias_map(n, 1 << log_bucket)
    return pack_table(h)


def expand_table(table, log_bucket):
    """The kernel's prologue in numpy: for each 12-bit slot, (offset, dist)
    as the uint32 words the step adds and multiplies, and the symbol."""
    t = table.astype(np.int64)
    j = np.arange(SLOTS)
    i = j >> log_bucket
    pos = j & ((1 << log_bucket) - 1)
    alias = pos >= t[3, i]  # signed
    off = np.where(alias, t[2, i] + pos, pos) & 0xFFFFFFFF  # int32 wrap-around
    dist = np.where(alias, t[4, i], t[0, i]) & 0xFFFFFFFF
    sym = np.where(alias, t[1, i], i).astype(np.int32)
    return off, dist, sym


def _word(row, w):
    """Word w of the row's virtual bytes row[clip(b, 0, L-1)], LSB-first."""
    b = np.clip(4 * w + np.arange(4), 0, len(row) - 1)
    return sum(int(row[x]) << (8 * n) for n, x in enumerate(b))


def kernel_decode(streams, table, log_bucket, T, ring_words):
    """The kernel's decode in numpy, step for step: the expanded table, a
    ring of `ring_words` words a stream whose next half is staged when the
    cursor's word enters a half (checked between chunks of 32 steps, and
    only while a step can still read past it), and the 16-bit halfword at
    the cursor taken on a renorm, the cursor held at word ceil(L / 4) past
    the row (every byte there is the row's last)."""
    off, dist, sym = expand_table(table, log_bucket)
    S, L = streams.shape
    half = ring_words // 2
    n_words = min((2 * T + 7) // 4, (L + 3) // 4 + 1)
    k_max = 2 * ((L + 3) // 4)
    toks = np.zeros((S, T), np.int32)
    finals = np.zeros(S, np.int64)
    for s in range(S):
        row = streams[s]
        ring = [_word(row, w) for w in range(ring_words)]
        stage_at = half
        state, k = ring[0], 2
        for t0 in range(0, T, CHUNK):
            if (min(k, k_max) >> 1) >= stage_at and stage_at + half < n_words:
                h = stage_at // half
                for w in range(half):
                    ring[((h + 1) & 1) * half + w] = _word(row, (h + 1) * half + w)
                stage_at += half
            for t in range(t0, min(T, t0 + CHUNK)):
                idx = state & 0xFFF
                kc = min(k, k_max)
                bits = (ring[(kc >> 1) & (ring_words - 1)] >> (16 * (kc & 1))) & 0xFFFF
                ns = ((state >> 12) * int(dist[idx]) + int(off[idx])) & 0xFFFFFFFF
                if ns < 1 << 16:
                    state, k = (ns << 16) | bits, k + 1
                else:
                    state = ns
                toks[s, t] = sym[idx]
        finals[s] = state
    return toks, finals


@pytest.mark.parametrize("kind", ["alias", "random_int32"])
@pytest.mark.parametrize("log_bucket", [0, 4, 6, 8, 12])
def test_expanded_table_is_one_jax_step_for_every_slot(log_bucket, kind):
    """Every slot of the expanded table against one step of the XLA twin:
    4096 streams, stream j starting in a state whose low 12 bits are j
    (high bits small or large, so that some steps renormalise)."""
    rng = np.random.default_rng(100 + log_bucket + (50 if kind == "alias" else 0))
    table = (alias_table(rng, log_bucket) if kind == "alias"
             else random_int32_table(rng, log_bucket))
    j = np.arange(SLOTS, dtype=np.int64)
    high = np.where(rng.random(SLOTS) < 0.5, rng.integers(0, 16, SLOTS),
                    rng.integers(0, 1 << 20, SLOTS))
    state = (high << 12) | j
    bits = rng.integers(0, 1 << 16, SLOTS)
    buf = np.zeros((SLOTS, 6), np.uint8)
    buf[:, :4] = state.astype("<u4").view(np.uint8).reshape(SLOTS, 4)
    buf[:, 4:] = bits.astype("<u2").view(np.uint8).reshape(SLOTS, 2)
    want_tok, want_state = jax_ans_decode_batch(buf, table, log_bucket, 1)

    off, dist, sym = expand_table(table, log_bucket)
    ns = ((state >> 12) * dist + off) & 0xFFFFFFFF
    got_state = np.where(ns < 1 << 16, (ns << 16) | bits, ns)
    np.testing.assert_array_equal(sym, np.asarray(want_tok)[:, 0])
    np.testing.assert_array_equal(got_state, np.asarray(want_state).astype(np.int64))
    if kind == "random_int32":  # the signed compare took both sides
        assert 0 < int((np.asarray(want_tok)[:, 0] != j >> log_bucket).sum()) < SLOTS


def _pad(datas, length):
    buf = np.zeros((len(datas), length), np.uint8)
    for i, d in enumerate(datas):
        n = min(len(d), length)
        buf[i, :n] = d[:n]
    return buf


def _decode_case(name):
    """(streams, table, log_bucket, T, ring words) of a case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("random_int32"):
        lb = int(name.rsplit("lb", 1)[1])
        return (rng.integers(0, 256, (5, 45), dtype=np.uint8), random_int32_table(rng, lb),
                lb, 70, None)
    h = make_hist(random_dist(rng, 48))
    table = pack_table(h)
    n_streams = 1 if name == "S1" else 9
    n_tokens = {"T0": 0, "T31": 31}.get(name, 600)
    if name.startswith("truncated"):
        n_tokens = 1000
    buf, _ = _streams(rng, h, 48, n_streams, max(n_tokens, 1), slack=0)
    if name.startswith("truncated"):  # cursors run past the rows' ends: the last byte again
        buf, n_tokens = np.ascontiguousarray(buf[:, : buf.shape[1] * 3 // 5]), 1200
    elif name == "odd_L":
        buf = _pad(list(buf), buf.shape[1] | 1)
    elif name in ("L1", "L3"):
        buf = np.ascontiguousarray(buf[:, : int(name[1])])
        n_tokens = 40
    ring = MIN_RING_WORDS if name.endswith("min_ring") else None
    return buf, table, LOG_BUCKET, n_tokens, ring


_DECODE_CASES = ["writer", "writer_min_ring", "truncated", "truncated_min_ring", "odd_L", "L1",
                 "L3", "T0", "S1", "T31", "random_int32_lb0", "random_int32_lb12"]


@pytest.mark.parametrize("name", _DECODE_CASES)
def test_kernel_mirror_decode_matches_jax_and_plain(name):
    buf, table, lb, T, ring = _decode_case(name)
    S, L = buf.shape
    if ring is None:  # the ring the wrapper's plan gives these streams
        ring = ans_lanes.k2_plan(S, T, L)["ring_words"]
    if name.endswith("min_ring"):  # the ring is restaged over real bytes
        assert L > 4 * ring
    want_t, want_f = jax_ans_decode_batch(buf, table, lb, T)
    plain_t, plain_f = device_ans.ans_decode_batch(torch.from_numpy(buf),
                                                   torch.from_numpy(table), lb, T)
    got_t, got_f = kernel_decode(buf, table, lb, T, ring)
    assert got_t.shape == (S, T) and plain_t.shape == (S, T)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_f, np.asarray(want_f).astype(np.int64))
    np.testing.assert_array_equal(plain_t.numpy(), got_t)
    np.testing.assert_array_equal(plain_f.numpy(), got_f)


def test_wrapper_refuses_bad_arguments():
    table = torch.from_numpy(pack_table(make_hist(random_dist(np.random.default_rng(3), 20))))
    with pytest.raises(ValueError):  # rows without a byte
        ans_lanes.ans_decode_batch(torch.zeros((2, 0), dtype=torch.uint8), table, 4, 5)
    with pytest.raises(ValueError):
        ans_lanes.ans_decode_batch(torch.zeros((2, 8), dtype=torch.uint8), table[:4], 4, 5)
    with pytest.raises(ValueError):  # 256 buckets of 2^3 slots do not cover 4096
        ans_lanes.ans_decode_batch(torch.zeros((2, 8), dtype=torch.uint8), table, 3, 5)
    with pytest.raises(ValueError):
        ans_lanes.ans_decode_batch(torch.zeros((2, 8), dtype=torch.uint8), table, 4, -1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", _DECODE_CASES + ["random_int32_lb4", "random_int32_lb8"])
def test_kernel_matches_plain_on_the_card(cuda_device, name):
    buf, table, lb, T, _ = _decode_case(name)
    st, tb = torch.from_numpy(buf).to(cuda_device), torch.from_numpy(table).to(cuda_device)
    before = ans_lanes.ans_decode_batch.launches
    toks, final = ans_lanes.ans_decode_batch(st, tb, lb, T)
    torch.cuda.synchronize()
    assert ans_lanes.ans_decode_batch.launches == before + 1
    want_toks, want_final = device_ans.ans_decode_batch(st, tb, lb, T)
    assert torch.equal(toks, want_toks) and torch.equal(final, want_final)
