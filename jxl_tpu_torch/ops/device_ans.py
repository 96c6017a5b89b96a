"""Batched rANS decode, one lane per stream, in plain torch.

The counterpart of jxl_tpu/ops/device_ans.py. The rANS state is a serial
chain within a stream, so the parallelism is across streams: each step
decodes one symbol in every lane (12-bit alias-table lookup, state update,
16-bit renormalisation from the lane's own bit cursor). `ans_decode_batch`
is the plain version of the kernel K2 (ops/ans_lanes.py,
csrc/ans_lanes.cu); `ans_read_uint_batch` adds the HybridUint tail bits
with a per-step cluster and runs on no decode path.

The state is carried in int64 and masked to 32 bits; final states come
back as int64 tensors holding the uint32 value. Math mirrors
entropy/ans.py AnsHistogram.read exactly (ref entropy_coding/ans.rs:
354-393).
"""

from __future__ import annotations

import numpy as np
import torch

LOG_SUM_PROBS = 12
SUM_PROBS = 1 << LOG_SUM_PROBS
_U32 = 0xFFFFFFFF


def pack_table(hist) -> np.ndarray:
    """(5, n_buckets) int32: dist, alias_symbol, alias_offset, alias_cutoff,
    alias_dist (entropy/ans.py layout)."""
    n = len(hist.alias_symbol)
    dist = list(hist.dist) + [0] * (n - len(hist.dist))
    return np.array(
        [dist[:n], hist.alias_symbol, hist.alias_offset, hist.alias_cutoff,
         hist.alias_dist],
        dtype=np.int32,
    )


def pack_clustered_tables(histograms) -> np.ndarray:
    """(C, 5, n_buckets) int32 from a list of AnsHistogram."""
    return np.stack([pack_table(h) for h in histograms])


def pack_uint_configs(configs) -> np.ndarray:
    """(C, 3) int32: split_exponent, msb_in_token, lsb_in_token."""
    return np.array(
        [[c.split_exponent, c.msb_in_token, c.lsb_in_token] for c in configs],
        dtype=np.int32,
    )


def read_bits(streams, bitpos, nbits):
    """Per-lane LSB-first read of `nbits` (<= 32) bits at the bit cursors
    `bitpos` of the (S, L) uint8 `streams`; byte indices are clipped to
    the row, so a cursor past the end reads the last byte again."""
    s, length = streams.shape
    rows = torch.arange(s, device=streams.device)[:, None]
    idx = (bitpos >> 3)[:, None] + torch.arange(5, device=streams.device)[None, :]
    b = streams[rows, idx.clamp(0, length - 1)].to(torch.int64)
    word = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24) | (b[:, 4] << 32)
    mask = torch.where(nbits >= 32, _U32, (1 << nbits.clamp(max=31)) - 1)
    return (word >> (bitpos & 7)) & mask


def ans_step(state, bitpos, streams, tab, log_bucket: int):
    """One rANS symbol in every lane: (symbol, state', bitpos'). tab(r, i)
    gives row r of each lane's table (dist, alias symbol, alias offset,
    alias cutoff, alias dist) at the lanes' buckets i."""
    idx = state & 0xFFF
    i = idx >> log_bucket
    pos = idx & ((1 << log_bucket) - 1)
    use_alias = pos >= tab(3, i)
    sym = torch.where(use_alias, tab(1, i), i)
    off = torch.where(use_alias, tab(2, i) + pos, pos)
    d = torch.where(use_alias, tab(4, i), tab(0, i))
    state = ((state >> LOG_SUM_PROBS) * d + off) & _U32
    renorm = state < (1 << 16)
    bits16 = read_bits(streams, bitpos, torch.full_like(bitpos, 16))
    state = torch.where(renorm, ((state << 16) | bits16) & _U32, state)
    bitpos = bitpos + torch.where(renorm, 16, 0)
    return sym, state, bitpos


def ans_decode_batch(streams, table, log_bucket_size: int, num_tokens: int):
    """Decode `num_tokens` symbols from each of S streams in lockstep.

    streams: (S, L) uint8 tensor (each starts with the 32-bit initial
    state, LSB-first, then renorm bits); table: (5, n_buckets) int32.
    Returns (tokens (S, T) int32, final_states (S,) int64 uint32 values).
    """
    s = streams.shape[0]
    t64 = table.to(torch.int64)
    state = read_bits(streams, torch.zeros(s, dtype=torch.int64, device=streams.device),
                      torch.full((s,), 32, dtype=torch.int64, device=streams.device))
    bitpos = torch.full((s,), 32, dtype=torch.int64, device=streams.device)
    toks = torch.empty((s, num_tokens), dtype=torch.int32, device=streams.device)
    for t in range(num_tokens):
        sym, state, bitpos = ans_step(state, bitpos, streams, lambda r, i: t64[r][i],
                                      log_bucket_size)
        toks[:, t] = sym.to(torch.int32)
    return toks, state


def hybrid_uint(token, se, msb, lsb, streams, bitpos):
    """HybridUint (ref hybrid_uint.rs:28-71) per lane: (value, bitpos')."""
    split = 1 << se
    bit = msb + lsb
    nbits = (se - bit + ((token - split) >> bit)) & 31
    nbits = torch.where(token < split, 0, nbits)
    raw = read_bits(streams, bitpos, nbits)
    low = token & ((1 << lsb) - 1)
    hi = ((token >> lsb) & ((1 << msb) - 1)) | (1 << msb)
    big = ((((hi << nbits) | raw) << lsb) | low) & _U32
    return torch.where(token < split, token, big), bitpos + nbits


def ans_read_uint_batch(streams, tables, uint_cfgs, clusters, log_bucket_size: int,
                        num_tokens: int):
    """Clustered ANS + HybridUint: `num_tokens` unsigned values per stream,
    with a per-(stream, step) cluster index.

    streams: (S, L) uint8; tables: (C, 5, NB) int32; uint_cfgs: (C, 3)
    int32; clusters: (S, T) int32. Returns (values (S, T) int64 holding
    uint32 values, final_states (S,) int64)."""
    s = streams.shape[0]
    dev = streams.device
    t64 = tables.to(torch.int64)
    cfg = uint_cfgs.to(torch.int64)
    state = read_bits(streams, torch.zeros(s, dtype=torch.int64, device=dev),
                      torch.full((s,), 32, dtype=torch.int64, device=dev))
    bitpos = torch.full((s,), 32, dtype=torch.int64, device=dev)
    vals = torch.empty((s, num_tokens), dtype=torch.int64, device=dev)
    for t in range(num_tokens):
        cl = clusters[:, t].to(torch.int64)
        sym, state, bitpos = ans_step(state, bitpos, streams,
                                      lambda r, i: t64[cl, r, i], log_bucket_size)
        c = cfg[cl]
        vals[:, t], bitpos = hybrid_uint(sym, c[:, 0], c[:, 1], c[:, 2], streams, bitpos)
    return vals, state
