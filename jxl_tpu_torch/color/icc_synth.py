"""ICC profile synthesis from a JXL color encoding.

Capability reference: jxl/src/api/color.rs:768 maybe_create_profile (+
create_icc_header :683, description strings :611, Bradford chromatic
adaptation :194, primaries matrix :125, MD5 profile ID :30). Synthesizes
an ICC v4.4 matrix/TRC profile — header, desc/cprt/wtpt/chad tags, per-
primary XYZ columns adapted to D50, parametric (or sampled, for PQ/HLG)
tone curves, CICP where defined — for files that carry a color encoding
instead of an embedded ICC profile.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from ..io.headers import ColorSpace, Primaries, TransferFunction, WhitePoint

# Bradford chromatic adaptation (ref color.rs:18-28)
_BRADFORD = np.array(
    [
        [0.8951, 0.2664, -0.1614],
        [-0.7502, 1.7135, 0.0367],
        [0.0389, -0.0685, 1.0296],
    ]
)
_BRADFORD_INV = np.linalg.inv(_BRADFORD)

_D50_XY = (0.345669, 0.358496)
D50_XYZ = (0.964203, 1.0, 0.824905)

_WP_COORDS = {
    WhitePoint.D65: (0.3127, 0.3290),
    WhitePoint.DCI: (0.314, 0.351),
    WhitePoint.E: (1.0 / 3.0, 1.0 / 3.0),
}
_PRIM_COORDS = {
    Primaries.SRGB: [
        (0.6399987, 0.33001015),
        (0.3000038, 0.60000336),
        (0.15000205, 0.059997204),
    ],
    Primaries.BT2100: [(0.708, 0.292), (0.170, 0.797), (0.131, 0.046)],
    Primaries.P3: [(0.680, 0.320), (0.265, 0.690), (0.150, 0.060)],
}


def white_point_xy(enc) -> tuple[float, float]:
    if enc.white_point == WhitePoint.CUSTOM:
        return enc.white.as_f32()
    return _WP_COORDS[enc.white_point]


def primaries_xy(enc):
    if enc.primaries == Primaries.CUSTOM:
        return [p.as_f32() for p in enc.custom_primaries]
    return _PRIM_COORDS[enc.primaries]


def _xyz_of(x: float, y: float) -> np.ndarray:
    return np.array([x / y, 1.0, (1.0 - x - y) / y], dtype=np.float64)


def primaries_to_xyz(prims, wx, wy) -> np.ndarray:
    """RGB->XYZ(native wp) 3x3 (ref color.rs:125-192)."""
    p = np.array(
        [
            [prims[0][0], prims[1][0], prims[2][0]],
            [prims[0][1], prims[1][1], prims[2][1]],
            [
                1.0 - prims[0][0] - prims[0][1],
                1.0 - prims[1][0] - prims[1][1],
                1.0 - prims[2][0] - prims[2][1],
            ],
        ],
        dtype=np.float64,
    )
    s = np.linalg.solve(p, _xyz_of(wx, wy))
    return p * s[None, :]


def adapt_to_xyz_d50(wx: float, wy: float) -> np.ndarray:
    """Bradford adaptation matrix wp->D50 (ref color.rs:194-254)."""
    lms_w = _BRADFORD @ _xyz_of(wx, wy)
    lms_d50 = _BRADFORD @ _xyz_of(*_D50_XY)
    scale = np.diag(lms_d50 / lms_w)
    return _BRADFORD_INV @ scale @ _BRADFORD


def primaries_to_xyz_d50(prims, wx, wy) -> np.ndarray:
    return adapt_to_xyz_d50(wx, wy) @ primaries_to_xyz(prims, wx, wy)


# -- tag serialization --------------------------------------------------------------


def _s15f16(v: float) -> bytes:
    return struct.pack(">i", int(round(v * 65536.0)))


def _mluc(text: str) -> bytes:
    utf16 = text.encode("utf-16-be")
    return (
        b"mluc"
        + struct.pack(">IIII", 0, 1, 12, 0x656E5553)  # 1 record, 'enUS'
        + struct.pack(">II", len(utf16), 28)
        + utf16
    )


def _xyz_tag(xyz) -> bytes:
    return b"XYZ " + b"\0" * 4 + b"".join(_s15f16(v) for v in xyz)


def _chad_tag(m: np.ndarray) -> bytes:
    return b"sf32" + b"\0" * 4 + b"".join(_s15f16(v) for v in m.flatten())


def _para_tag(curve_type: int, params) -> bytes:
    return (
        b"para"
        + b"\0" * 4
        + struct.pack(">HH", curve_type, 0)
        + b"".join(_s15f16(p) for p in params)
    )


def _curv_table_tag(values: np.ndarray) -> bytes:
    q = np.clip(np.round(values * 65535.0), 0, 65535).astype(">u2")
    return b"curv" + b"\0" * 4 + struct.pack(">I", len(q)) + q.tobytes()


def _trc_tag(tf, gamma_value: float | None, intensity_target: float) -> bytes:
    """Tone reproduction curve for a transfer function (ref color.rs:970-1005)."""
    from . import tf as tfmod

    if gamma_value is not None:
        return _para_tag(0, [1.0 / gamma_value])
    if tf == TransferFunction.SRGB:
        return _para_tag(3, [2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045])
    if tf == TransferFunction.BT709:
        return _para_tag(3, [1.0 / 0.45, 1.0 / 1.099, 0.099 / 1.099, 1.0 / 4.5, 0.081])
    if tf == TransferFunction.LINEAR:
        return _para_tag(3, [1.0, 1.0, 0.0, 1.0, 0.0])
    if tf == TransferFunction.DCI:
        return _para_tag(3, [2.6, 1.0, 0.0, 1.0, 0.0])
    if tf == TransferFunction.PQ:
        e = np.linspace(0.0, 1.0, 4096, dtype=np.float64)
        lin = tfmod.pq_to_linear(torch.from_numpy(e.astype(np.float32)), intensity_target)
        return _curv_table_tag(np.clip(lin.numpy(), 0.0, 1.0))
    if tf == TransferFunction.HLG:
        e = np.linspace(0.0, 1.0, 4096, dtype=np.float32)
        lin = tfmod.hlg_to_scene(torch.from_numpy(e))
        return _curv_table_tag(np.clip(lin.numpy(), 0.0, 1.0))
    raise ValueError(f"cannot synthesize TRC for {tf}")


def _cicp_tag(enc) -> bytes | None:
    """CICP (coding-independent code points) when all three map (ref :524)."""
    prim = {Primaries.SRGB: 1, Primaries.BT2100: 9, Primaries.P3: 12}.get(enc.primaries)
    tfv = None
    if not enc.tf.have_gamma:
        tfv = {
            TransferFunction.BT709: 1,
            TransferFunction.SRGB: 13,
            TransferFunction.PQ: 16,
            TransferFunction.DCI: 17,
            TransferFunction.HLG: 18,
            TransferFunction.LINEAR: 8,
        }.get(enc.tf.transfer_function)
    if prim is None or tfv is None or enc.white_point != WhitePoint.D65:
        return None
    return b"cicp" + b"\0" * 4 + bytes([prim, tfv, 0, 1])


def describe(enc) -> str:
    """Color encoding description string (ref color.rs:611-681)."""
    ri = {0: "Per", 1: "Rel", 2: "Sat", 3: "Abs"}[int(enc.rendering_intent)]
    if enc.color_space == ColorSpace.XYB:
        return f"XYB_{ri}"
    wp_s = {
        WhitePoint.D65: "D65",
        WhitePoint.E: "EER",
        WhitePoint.DCI: "DCI",
    }.get(enc.white_point)
    if wp_s is None:
        wx, wy = enc.white.as_f32()
        wp_s = f"{wx:.7f};{wy:.7f}"
    ri_s = {0: "Per", 1: "Rel", 2: "Sat", 3: "Abs"}[int(enc.rendering_intent)]
    if enc.tf.have_gamma:
        tf_s = f"g{enc.tf.gamma_value():.7f}"
    else:
        tf_s = {
            TransferFunction.BT709: "709",
            TransferFunction.LINEAR: "Lin",
            TransferFunction.SRGB: "SRG",
            TransferFunction.PQ: "PeQ",
            TransferFunction.DCI: "DCI",
            TransferFunction.HLG: "HLG",
        }[enc.tf.transfer_function]
    if enc.color_space == ColorSpace.GRAY:
        return f"Gra_{wp_s}_{ri_s}_{tf_s}"
    pr_s = {
        Primaries.SRGB: "SRG",
        Primaries.BT2100: "202",
        Primaries.P3: "DCI",
    }.get(enc.primaries)
    if pr_s is None:
        c = [p.as_f32() for p in enc.custom_primaries]
        pr_s = ";".join(f"{x:.7f},{y:.7f}" for x, y in c)
    # common names
    if (
        enc.white_point == WhitePoint.D65
        and not enc.tf.have_gamma
    ):
        key = (enc.primaries, enc.tf.transfer_function, int(enc.rendering_intent))
        common = {
            (Primaries.SRGB, TransferFunction.SRGB, 0): "sRGB",
            (Primaries.P3, TransferFunction.SRGB, 0): "DisplayP3",
            (Primaries.BT2100, TransferFunction.PQ, 1): "Rec2100PQ",
            (Primaries.BT2100, TransferFunction.HLG, 1): "Rec2100HLG",
        }.get(key)
        if common:
            return common
    return f"RGB_{wp_s}_{pr_s}_{ri_s}_{tf_s}"


def _header(enc) -> bytearray:
    """128-byte ICC v4.4 header (ref color.rs:683-766)."""
    h = bytearray(128)
    h[4:8] = b"jxl "  # CMM
    struct.pack_into(">I", h, 8, 0x04400000)  # v4.4
    h[12:16] = b"scnr" if enc.color_space == ColorSpace.XYB else b"mntr"
    h[16:20] = b"GRAY" if enc.color_space == ColorSpace.GRAY else b"RGB "
    h[20:24] = b"XYZ "  # PCS
    struct.pack_into(">HHHHHH", h, 24, 2019, 12, 1, 0, 0, 0)  # fixed date
    h[36:40] = b"acsp"
    h[40:44] = b"APPL"
    struct.pack_into(">I", h, 64, int(enc.rendering_intent))
    struct.pack_into(">III", h, 68, 0x0000F6D6, 0x00010000, 0x0000D32D)  # D50
    h[80:84] = b"jxl "  # creator
    return h


# -- XYB output profile (A2B0 LUT) --------------------------------------------
# Constants mirror the normative opsin math (ref api/xyb_constants.rs).

_OPSIN_BIAS = 0.0037930732552754493
_SCALED_XYB_OFFSET = (0.015386134, 0.0, 0.27770459)
_SCALED_XYB_SCALE = (22.995788804, 1.183000077, 1.502141333)
_XYB_ICC_MATRIX = (
    1.5170095, -1.1065225, 0.071623,
    -0.050022, 0.5683655, -0.018344,
    -1.387676, 1.1145555, 0.6857255,
)


def _xyb_offset():
    so, ss = _SCALED_XYB_OFFSET, _SCALED_XYB_SCALE
    return (so[0] + so[1], so[1] - so[0] + 1.0 / ss[0], so[1] + so[2])


def _xyb_scale():
    ss = _SCALED_XYB_SCALE

    def rsum(a, b):
        return (a * b) / (a + b)

    return (rsum(ss[0], ss[1]), rsum(ss[0], ss[1]), rsum(ss[1], ss[2]))


def _para_curve_bytes(curve_type: int, params) -> bytes:
    out = bytearray(b"para" + b"\0" * 4)
    out += struct.pack(">HH", curve_type, 0)
    for p in params:
        out += _s15f16(p)
    return bytes(out)


def _xyb_a2b0_tag() -> bytes:
    """'mAB ' LUT tag mapping XYB samples to PCS XYZ via a 2^3 CLUT +
    cube-root M curves + opsin matrix (ref color.rs:2045-2143)."""
    off, scale = _xyb_offset(), _xyb_scale()
    t = bytearray(b"mAB " + b"\0" * 4)
    t += bytes([3, 3]) + b"\0\0"
    t += struct.pack(">IIIII", 32, 244, 148, 80, 32)
    # offset 32: B curves = A curves = 3 identity gamma curves (12 B each)
    for _ in range(3):
        t += _para_curve_bytes(0, [1.0])
    # offset 80: CLUT header (16 grid-point bytes, precision 2, pad)
    t += bytes([2, 2, 2] + [0] * 13) + bytes([2, 0]) + b"\0\0"
    # 2x2x2 cube of unscaled XYB corners
    so, ss = _SCALED_XYB_OFFSET, _SCALED_XYB_SCALE

    def corner(x, y, b, idx):
        v = (x, y, b)[idx]
        return v / ss[idx] - so[idx]

    for x in range(2):
        for y in range(2):
            for b in range(2):
                vals = (
                    (corner(x, y, b, 1) + corner(x, y, b, 0) + off[0]) * scale[0],
                    (corner(x, y, b, 1) - corner(x, y, b, 0) + off[1]) * scale[1],
                    (corner(x, y, b, 2) + corner(x, y, b, 1) + off[2]) * scale[2],
                )
                for v in vals:
                    t += struct.pack(">H", int(np.clip(round(65535.0 * v), 0, 65535)))
    # offset 148: M curves — type-3 parametric cube curves.
    # b = -XYB_OFFSET[i] - cbrt(NEG_OPSIN_ABSORBANCE_BIAS); the bias is
    # negative, so the sign-preserving cube root applies
    neg_bias = -_OPSIN_BIAS
    cbrt_bias = -((-neg_bias) ** (1.0 / 3.0))
    for i in range(3):
        b = -off[i] - cbrt_bias
        t += _para_curve_bytes(
            3, [3.0, 1.0 / scale[i], b, 0.0, max(-b * scale[i], 0.0)]
        )
    # offset 244: matrix (9 values + 3 intercepts)
    for v in _XYB_ICC_MATRIX:
        t += _s15f16(v)
    for i in range(3):
        intercept = sum(
            _XYB_ICC_MATRIX[i * 3 + j] * (-_OPSIN_BIAS) for j in range(3)
        )
        t += _s15f16(intercept)
    return bytes(t)


def _noop_b2a0_tag() -> bytes:
    """'mBA ' identity tag (required by Apple software, ref color.rs:2209)."""
    t = bytearray(b"mBA " + b"\0" * 4)
    t += bytes([3, 3]) + b"\0\0"
    t += struct.pack(">IIIII", 32, 0, 0, 0, 0)
    for _ in range(3):
        t += _para_curve_bytes(0, [1.0])
    return bytes(t)


def synthesize_icc(enc, intensity_target: float = 255.0) -> bytes:
    """Create an ICC profile for a (non-ICC) JXL color encoding, including
    XYB output profiles (A2B0 LUT).

    ref api/color.rs:768 maybe_create_profile."""
    if enc.color_space == ColorSpace.XYB:
        return _synthesize_xyb_icc(enc)
    is_gray = enc.color_space == ColorSpace.GRAY
    wx, wy = white_point_xy(enc)

    tags: list[tuple[bytes, bytes, int | None]] = []  # (sig, data, alias_of)

    def add(sig: bytes, data: bytes):
        tags.append((sig, data, None))

    add(b"desc", _mluc(describe(enc)))
    add(b"cprt", _mluc("CC0"))
    if is_gray:
        add(b"wtpt", _xyz_tag(_xyz_of(wx, wy)))
    else:
        add(b"wtpt", _xyz_tag(D50_XYZ))
        add(b"chad", _chad_tag(adapt_to_xyz_d50(wx, wy)))
        cicp = _cicp_tag(enc)
        if cicp is not None:
            add(b"cicp", cicp)
        m = primaries_to_xyz_d50(primaries_xy(enc), wx, wy)
        add(b"rXYZ", _xyz_tag(m[:, 0]))
        add(b"gXYZ", _xyz_tag(m[:, 1]))
        add(b"bXYZ", _xyz_tag(m[:, 2]))

    gamma = enc.tf.gamma_value() if enc.tf.have_gamma else None
    trc = _trc_tag(
        None if gamma is not None else enc.tf.transfer_function, gamma, intensity_target
    )
    if is_gray:
        add(b"kTRC", trc)
    else:
        # rTRC/gTRC/bTRC share one curve blob (ref :1019-1035)
        rtrc_idx = len(tags)
        tags.append((b"rTRC", trc, None))
        tags.append((b"gTRC", b"", rtrc_idx))
        tags.append((b"bTRC", b"", rtrc_idx))

    return _assemble_profile(enc, tags)


def _synthesize_xyb_icc(enc) -> bytes:
    """XYB output profile: scnr class, A2B0 LUT + noop B2A0
    (ref color.rs:940-962)."""
    tags: list[tuple[bytes, bytes, int | None]] = []
    tags.append((b"desc", _mluc(describe(enc)), None))
    tags.append((b"cprt", _mluc("CC0"), None))
    tags.append((b"wtpt", _xyz_tag(D50_XYZ), None))
    # chromatic adaptation for D65 (XYB white point)
    tags.append((b"chad", _chad_tag(adapt_to_xyz_d50(0.3127, 0.3290)), None))
    tags.append((b"A2B0", _xyb_a2b0_tag(), None))
    tags.append((b"B2A0", _noop_b2a0_tag(), None))
    return _assemble_profile(enc, tags)


def _assemble_profile(enc, tags) -> bytes:
    header = _header(enc)
    table_size = 4 + 12 * len(tags)
    blob = bytearray()
    offsets: list[tuple[bytes, int, int]] = []
    blob_base = len(header) + table_size
    placed: dict[int, tuple[int, int]] = {}
    for i, (sig, data, alias) in enumerate(tags):
        if alias is not None:
            off, size = placed[alias]
        else:
            off = blob_base + len(blob)
            size = len(data)
            blob.extend(data)
            while len(blob) % 4:
                blob.append(0)
            placed[i] = (off, size)
        offsets.append((sig, off, size))

    table = bytearray(struct.pack(">I", len(tags)))
    for sig, off, size in offsets:
        table += sig + struct.pack(">II", off, size)

    profile = bytearray(header) + table + blob
    struct.pack_into(">I", profile, 0, len(profile))

    # profile ID: MD5 with flags/intent/ID zeroed (ICC spec; ref :30, :1085-)
    tmp = bytearray(profile)
    tmp[44:48] = b"\0" * 4
    tmp[64:68] = b"\0" * 4
    tmp[84:100] = b"\0" * 16
    profile[84:100] = hashlib.md5(bytes(tmp)).digest()
    return bytes(profile)
