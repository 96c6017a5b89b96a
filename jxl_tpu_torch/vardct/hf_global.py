"""HfGlobal: dequant matrices, per-pass coefficient orders + AC histograms.

Capability reference: jxl/src/frame/decode.rs:513-583; the counterpart
of jxl_tpu/vardct/hf_global.py. Single-pass frames with default matrices
decode in one native call; the readers below cover custom matrices and
more passes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..entropy import Histograms
from ..io.bit_reader import BitReader
from .block_context import ZERO_DENSITY_CONTEXT_COUNT, ZERO_DENSITY_CONTEXT_LIMIT
from .coeff_order import NUM_ORDERS, decode_coeff_orders
from .quant_weights import DequantMatrices


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


@dataclass
class PassState:
    coeff_orders: list
    histograms: Histograms


@dataclass
class HfGlobalState:
    num_histograms: int
    passes: list
    dequant_matrices: DequantMatrices
    # multi-pass coefficient accumulators, allocated lazily per group
    hf_coefficients: dict


def decode_hf_global(frame, br: BitReader) -> HfGlobalState:
    bctx = frame.lf_global.block_context_map
    if frame.header.passes.num_passes == 1:
        from .. import native

        res = native.decode_hf_global_native(
            br, _ceil_log2(frame.header.num_groups), bctx.num_ac_contexts
        )
        if res is not None:
            from .coeff_order import CoeffOrders
            from .quant_weights import NUM_QUANT_TABLES, library_table

            num_histograms, _used, coded, histograms = res
            num_contexts = num_histograms * bctx.num_ac_contexts
            histograms.resize(
                num_contexts
                + ZERO_DENSITY_CONTEXT_LIMIT
                - ZERO_DENSITY_CONTEXT_COUNT
            )
            return HfGlobalState(
                num_histograms,
                [PassState(CoeffOrders(coded), histograms)],
                DequantMatrices(
                    [library_table(i) for i in range(NUM_QUANT_TABLES)]
                ),
                {},
            )
    dequant_matrices = DequantMatrices.decode(frame, br)
    num_histo_bits = _ceil_log2(frame.header.num_groups)
    num_histograms = br.read(num_histo_bits) + 1
    passes = []
    for _ in range(frame.header.passes.num_passes):
        sel = br.read(2)
        if sel == 0:
            used_orders = 0x5F
        elif sel == 1:
            used_orders = 0x13
        elif sel == 2:
            used_orders = 0
        else:
            used_orders = br.read(NUM_ORDERS)
        coeff_orders = decode_coeff_orders(used_orders, br)
        num_contexts = num_histograms * bctx.num_ac_contexts
        histograms = Histograms.decode(num_contexts, br, allow_lz77=True)
        # pad the context map so zero-density contexts beyond the
        # spec supremum don't index out of bounds (ref decode.rs:543-545)
        histograms.resize(num_contexts + ZERO_DENSITY_CONTEXT_LIMIT - ZERO_DENSITY_CONTEXT_COUNT)
        passes.append(PassState(coeff_orders, histograms))
    return HfGlobalState(num_histograms, passes, dequant_matrices, {})
