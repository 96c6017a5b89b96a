"""Image-level headers: signature, size, metadata, color encoding, upsampling
weights.

Field layouts follow ISO/IEC 18181-1 (capability reference:
jxl/src/headers/{size,image_metadata,bit_depth,extra_channels,
color_encoding,transform_data}.rs). The default 2x/4x/8x upsampling kernels
and the opsin inverse matrix are normative spec constants.
"""

from __future__ import annotations

import enum

from ...errors import DimShiftTooLarge, ImageDimensionTooLarge, InvalidBitsPerSample, InvalidBitstream, InvalidColorEncoding, InvalidExponent, InvalidGamma, InvalidIntensityTarget, InvalidLinearBelow, InvalidMantissa, InvalidMinNits, InvalidSignature, TooManyExtraChannels
from ..bit_reader import BitReader
from ..bundle import (
    Array,
    Bits,
    BitsOffset,
    Bool,
    Enum,
    Extensions,
    F16,
    JxlString,
    U32,
    Val,
    Vector,
    bundle,
    field,
)

# ---------------------------------------------------------------------------


class Orientation(enum.IntEnum):
    IDENTITY = 1
    FLIP_HORIZONTAL = 2
    ROTATE_180 = 3
    FLIP_VERTICAL = 4
    TRANSPOSE = 5
    ROTATE_90_CW = 6
    ANTI_TRANSPOSE = 7
    ROTATE_90_CCW = 8

    @property
    def is_transposing(self) -> bool:
        return self in (
            Orientation.TRANSPOSE,
            Orientation.ANTI_TRANSPOSE,
            Orientation.ROTATE_90_CW,
            Orientation.ROTATE_90_CCW,
        )


class ColorSpace(enum.IntEnum):
    RGB = 0
    GRAY = 1
    XYB = 2
    UNKNOWN = 3


class WhitePoint(enum.IntEnum):
    D65 = 1
    CUSTOM = 2
    E = 10
    DCI = 11


class Primaries(enum.IntEnum):
    SRGB = 1
    CUSTOM = 2
    BT2100 = 9
    P3 = 11


class TransferFunction(enum.IntEnum):
    BT709 = 1
    UNKNOWN = 2
    LINEAR = 8
    SRGB = 13
    PQ = 16
    DCI = 17
    HLG = 18


class RenderingIntent(enum.IntEnum):
    PERCEPTUAL = 0
    RELATIVE = 1
    SATURATION = 2
    ABSOLUTE = 3


class ExtraChannel(enum.IntEnum):
    ALPHA = 0
    DEPTH = 1
    SPOT_COLOR = 2
    SELECTION_MASK = 3
    BLACK = 4
    CFA = 5
    THERMAL = 6
    RESERVED0 = 7
    RESERVED1 = 8
    RESERVED2 = 9
    RESERVED3 = 10
    RESERVED4 = 11
    RESERVED5 = 12
    RESERVED6 = 13
    RESERVED7 = 14
    UNKNOWN = 15
    OPTIONAL = 16


# -- size -----------------------------------------------------------------

_RATIOS = {1: (1, 1), 2: (12, 10), 3: (4, 3), 4: (3, 2), 5: (16, 9), 6: (5, 4), 7: (2, 1)}


def _apply_ratio(ysize: int, ratio: int, fallback: int) -> int:
    if ratio == 0:
        return fallback
    num, den = _RATIOS[ratio]
    return ysize * num // den


@bundle
class Size:
    small: bool = field(Bool())
    ysize_div8 = field(BitsOffset(5, 1), condition=lambda s, ns: s.small)
    _ysize = field(
        lambda s, ns: U32(Bits(9), Bits(13), Bits(18), Bits(30)),
        condition=lambda s, ns: not s.small,
    )
    ratio: int = field(Bits(3))
    xsize_div8 = field(
        BitsOffset(5, 1), condition=lambda s, ns: s.small and s.ratio == 0
    )
    _xsize = field(
        lambda s, ns: U32(Bits(9), Bits(13), Bits(18), Bits(30)),
        condition=lambda s, ns: not s.small and s.ratio == 0,
    )

    @property
    def ysize(self) -> int:
        return self.ysize_div8 * 8 if self.small else self._ysize + 1

    @property
    def xsize(self) -> int:
        if self.ratio == 0:
            fb = self.xsize_div8 * 8 if self.small else self._xsize + 1
        else:
            fb = 0
        x = _apply_ratio(self.ysize, self.ratio, fb)
        if x >= (1 << 32):
            raise ImageDimensionTooLarge(f"image xsize {x} too large")
        return x

    def check(self, ns):
        _ = self.xsize


@bundle
class Preview:
    div8: bool = field(Bool())
    ysize_div8 = field(
        U32(Val(16), Val(32), BitsOffset(5, 1), BitsOffset(9, 33)),
        condition=lambda s, ns: s.div8,
    )
    _ysize = field(
        U32(Bits(6), BitsOffset(8, 64), BitsOffset(10, 320), BitsOffset(12, 1344)),
        condition=lambda s, ns: not s.div8,
    )
    ratio: int = field(Bits(3))
    xsize_div8 = field(
        U32(Val(16), Val(32), BitsOffset(5, 1), BitsOffset(9, 33)),
        condition=lambda s, ns: s.div8 and s.ratio == 0,
    )
    _xsize = field(
        U32(Bits(6), BitsOffset(8, 64), BitsOffset(10, 320), BitsOffset(12, 1344)),
        condition=lambda s, ns: not s.div8 and s.ratio == 0,
    )

    @property
    def ysize(self) -> int:
        return self.ysize_div8 * 8 if self.div8 else self._ysize + 1

    @property
    def xsize(self) -> int:
        if self.ratio == 0:
            fb = self.xsize_div8 * 8 if self.div8 else self._xsize + 1
        else:
            fb = 0
        return _apply_ratio(self.ysize, self.ratio, fb)


# -- bit depth ------------------------------------------------------------


@bundle
class BitDepth:
    floating_point_sample: bool = field(Bool(), default=False)
    bits_per_sample: int = field(
        lambda s, ns: (
            U32(Val(32), Val(16), Val(24), BitsOffset(6, 1))
            if s.floating_point_sample
            else U32(Val(8), Val(10), Val(12), BitsOffset(6, 1))
        ),
        default=8,
    )
    exponent_bits_per_sample: int = field(
        BitsOffset(4, 1), condition=lambda s, ns: s.floating_point_sample, default=0
    )

    def check(self, ns):
        if self.floating_point_sample:
            e = self.exponent_bits_per_sample
            if not (2 <= e <= 8):
                raise InvalidExponent(f"invalid exponent bits {e}")
            m = self.bits_per_sample - e - 1
            if not (2 <= m <= 23):
                raise InvalidMantissa(f"invalid mantissa bits {m}")
        elif self.bits_per_sample > 31:
            raise InvalidBitsPerSample(f"invalid bits_per_sample {self.bits_per_sample}")

    @staticmethod
    def integer(bits: int) -> "BitDepth":
        bd = BitDepth.__new__(BitDepth)
        bd.floating_point_sample = False
        bd.bits_per_sample = bits
        bd.exponent_bits_per_sample = 0
        return bd


_DEFAULT_BIT_DEPTH = BitDepth.integer(8)


# -- extra channels ---------------------------------------------------------


@bundle
class ExtraChannelInfo:
    all_default: bool = field(Bool())
    ec_type = field(Enum(ExtraChannel), default=ExtraChannel.ALPHA)
    bit_depth = field(BitDepth, default=_DEFAULT_BIT_DEPTH)
    dim_shift: int = field(U32(Val(0), Val(3), Val(4), BitsOffset(3, 1)), default=0)
    name: str = field(JxlString(), default="")
    alpha_associated: bool = field(
        Bool(), condition=lambda s, ns: s.ec_type == ExtraChannel.ALPHA, default=False
    )
    spot_color = field(
        Array(4, F16()), condition=lambda s, ns: s.ec_type == ExtraChannel.SPOT_COLOR
    )
    cfa_channel = field(
        U32(Val(1), Bits(2), BitsOffset(4, 3), BitsOffset(8, 19)),
        condition=lambda s, ns: s.ec_type == ExtraChannel.CFA,
    )

    def check(self, ns):
        if self.dim_shift > 3:
            raise DimShiftTooLarge(f"dim_shift {self.dim_shift} too large")


# -- color encoding ---------------------------------------------------------


@bundle
class CustomXY:
    x: int = field(
        U32(Bits(19), BitsOffset(19, 524288), BitsOffset(20, 1048576), BitsOffset(21, 2097152)),
        default=0,
    )
    y: int = field(
        U32(Bits(19), BitsOffset(19, 524288), BitsOffset(20, 1048576), BitsOffset(21, 2097152)),
        default=0,
    )

    # Stored value is unpack_signed'd per the u2S coder in the reference.
    def as_f32(self):
        from ..bundle import unpack_signed

        return (unpack_signed(self.x) / 1e6, unpack_signed(self.y) / 1e6)


def _default_custom_xy():
    c = CustomXY.__new__(CustomXY)
    c.x = 0
    c.y = 0
    return c


@bundle
class CustomTransferFunction:
    # nonserialized: ns = ColorSpace of the enclosing encoding
    have_gamma: bool = field(
        Bool(), condition=lambda s, ns: ns != ColorSpace.XYB, default=False
    )
    gamma: int = field(Bits(24), condition=lambda s, ns: s.have_gamma, default=3333333)
    transfer_function = field(
        Enum(TransferFunction),
        condition=lambda s, ns: not s.have_gamma and ns != ColorSpace.XYB,
        default=TransferFunction.SRGB,
    )

    def gamma_value(self) -> float:
        return self.gamma * 1e-7

    def check(self, ns):
        if self.have_gamma:
            g = self.gamma_value()
            if g > 1.0 or g * 8192.0 < 1.0:
                raise InvalidGamma(f"invalid gamma {g}")


def _default_ctf():
    t = CustomTransferFunction.__new__(CustomTransferFunction)
    t.have_gamma = False
    t.gamma = 3333333
    t.transfer_function = TransferFunction.SRGB
    return t


@bundle
class ColorEncoding:
    all_default: bool = field(Bool())
    want_icc: bool = field(Bool(), default=False)
    color_space = field(Enum(ColorSpace), default=ColorSpace.RGB)
    white_point = field(
        Enum(WhitePoint),
        condition=lambda s, ns: not s.want_icc and s.color_space != ColorSpace.XYB,
        default=WhitePoint.D65,
    )
    white = field(
        CustomXY,
        condition=lambda s, ns: s.white_point == WhitePoint.CUSTOM,
        default=lambda s, ns: _default_custom_xy(),
    )
    primaries = field(
        Enum(Primaries),
        condition=lambda s, ns: not s.want_icc
        and s.color_space not in (ColorSpace.XYB, ColorSpace.GRAY),
        default=Primaries.SRGB,
    )
    custom_primaries = field(
        Array(3, CustomXY),
        condition=lambda s, ns: s.primaries == Primaries.CUSTOM,
        default=lambda s, ns: [_default_custom_xy() for _ in range(3)],
    )
    tf = field(
        lambda s, ns: _CtfReader(s.color_space),
        condition=lambda s, ns: not s.want_icc,
        default=lambda s, ns: _default_ctf(),
    )
    rendering_intent = field(
        Enum(RenderingIntent),
        condition=lambda s, ns: not s.want_icc,
        default=RenderingIntent.RELATIVE,
    )

    def check(self, ns):
        if (
            self.color_space in (ColorSpace.UNKNOWN, ColorSpace.XYB)
            or self.tf.transfer_function == TransferFunction.UNKNOWN
        ):
            raise InvalidColorEncoding("invalid color encoding")


class _CtfReader:
    """Adapter passing the enclosing color space as nonserialized input."""

    def __init__(self, color_space):
        self.color_space = color_space

    def read(self, br: BitReader):
        return CustomTransferFunction.read_bundle(br, self.color_space)


# -- animation / tone mapping ------------------------------------------------


@bundle
class Animation:
    tps_numerator: int = field(U32(Val(100), Val(1000), BitsOffset(10, 1), BitsOffset(30, 1)))
    tps_denominator: int = field(U32(Val(1), Val(1001), BitsOffset(8, 1), BitsOffset(10, 1)))
    num_loops: int = field(U32(Val(0), Bits(3), Bits(16), Bits(32)))
    have_timecodes: bool = field(Bool())


@bundle
class ToneMapping:
    all_default: bool = field(Bool())
    intensity_target: float = field(F16(), default=255.0)
    min_nits: float = field(F16(), default=0.0)
    relative_to_max_display: bool = field(Bool(), default=False)
    linear_below: float = field(F16(), default=0.0)

    def check(self, ns):
        if self.intensity_target <= 0.0:
            raise InvalidIntensityTarget("invalid intensity target")
        if self.min_nits < 0.0 or self.min_nits > self.intensity_target:
            raise InvalidMinNits("invalid min_nits")
        if self.linear_below < 0.0 or (
            self.relative_to_max_display and self.linear_below > 1.0
        ):
            raise InvalidLinearBelow("invalid linear_below")


def _default_tone_mapping():
    t = ToneMapping.__new__(ToneMapping)
    t.all_default = True
    t.intensity_target = 255.0
    t.min_nits = 0.0
    t.relative_to_max_display = False
    t.linear_below = 0.0
    return t


# -- image metadata -----------------------------------------------------------


@bundle
class ImageMetadata:
    all_default: bool = field(Bool())
    extra_fields: bool = field(Bool(), default=False)
    orientation = field(
        _OrientationCoder := None,  # replaced below
        condition=lambda s, ns: s.extra_fields,
        default=Orientation.IDENTITY,
    )
    have_intrinsic_size: bool = field(
        Bool(), condition=lambda s, ns: s.extra_fields, default=False
    )
    intrinsic_size = field(Size, condition=lambda s, ns: s.have_intrinsic_size)
    have_preview: bool = field(Bool(), condition=lambda s, ns: s.extra_fields, default=False)
    preview = field(Preview, condition=lambda s, ns: s.have_preview)
    have_animation: bool = field(Bool(), condition=lambda s, ns: s.extra_fields, default=False)
    animation = field(Animation, condition=lambda s, ns: s.have_animation)
    bit_depth = field(BitDepth, default=_DEFAULT_BIT_DEPTH)
    modular_16bit_sufficient: bool = field(Bool(), default=True)
    extra_channel_info = field(
        Vector(U32(Val(0), Val(1), BitsOffset(4, 2), BitsOffset(12, 1)), ExtraChannelInfo),
        default=lambda s, ns: [],
    )
    xyb_encoded: bool = field(Bool(), default=True)
    color_encoding = field(ColorEncoding, default=lambda s, ns: default_color_encoding())
    tone_mapping = field(
        ToneMapping,
        condition=lambda s, ns: s.extra_fields,
        default=lambda s, ns: _default_tone_mapping(),
    )
    extensions = field(Extensions(), default=lambda s, ns: {})

    def check(self, ns):
        if len(self.extra_channel_info) > 256:
            raise TooManyExtraChannels("too many extra channels")

    @property
    def num_extra_channels(self) -> int:
        return len(self.extra_channel_info)


class _OrientationReader:
    def read(self, br: BitReader):
        return Orientation(br.read(3) + 1)


# patch the placeholder coder (class body can't reference helpers cleanly)
for _spec in ImageMetadata._bundle_fields:
    if _spec.name == "orientation":
        _spec.coder = _OrientationReader()


def default_color_encoding() -> ColorEncoding:
    c = ColorEncoding.__new__(ColorEncoding)
    c.all_default = True
    c.want_icc = False
    c.color_space = ColorSpace.RGB
    c.white_point = WhitePoint.D65
    c.white = _default_custom_xy()
    c.primaries = Primaries.SRGB
    c.custom_primaries = [_default_custom_xy() for _ in range(3)]
    c.tf = _default_ctf()
    c.rendering_intent = RenderingIntent.RELATIVE
    return c


# -- upsampling weights + opsin matrix ----------------------------------------

OPSIN_INVERSE_MATRIX_DEFAULT = (
    11.031566901960783, -9.866943921568629, -0.16462299647058826,
    -3.254147380392157, 4.418770392156863, -0.16462299647058826,
    -3.6588512862745097, 2.7129230470588235, 1.9459282392156863,
)
OPSIN_BIASES_DEFAULT = (-0.0037930732552754493,) * 3
QUANT_BIASES_DEFAULT = (
    1.0 - 0.05465007330715401,
    1.0 - 0.07005449891748593,
    1.0 - 0.049935103337343655,
    0.145,
)

# Normative default upsampling kernels (spec Table: default weights for
# 2x/4x/8x upsampling; ref transform_data.rs:31-318).
DEFAULT_KERN_2 = (
    -0.01716200, -0.03452303, -0.04022174, -0.02921014, -0.00624645,
    0.14111091, 0.28896755, 0.00278718, -0.01610267, 0.56661550,
    0.03777607, -0.01986694, -0.03144731, -0.01185068, -0.00213539,
)

DEFAULT_KERN_4 = (
    -0.02419067, -0.03491987, -0.03693351, -0.03094285, -0.00529785,
    -0.01663432, -0.03556863, -0.03888905, -0.03516850, -0.00989469,
    0.23651958, 0.33392945, -0.01073543, -0.01313181, -0.03556694,
    0.13048175, 0.40103025, 0.03951150, -0.02077584, 0.46914198,
    -0.00209270, -0.01484589, -0.04064806, 0.18942530, 0.56279892,
    0.06674400, -0.02335494, -0.03551682, -0.00754830, -0.02267919,
    -0.02363578, 0.00315804, -0.03399098, -0.01359519, -0.00091653,
    -0.00335467, -0.01163294, -0.01610294, -0.00974088, -0.00191622,
    -0.01095446, -0.03198464, -0.04455121, -0.02799790, -0.00645912,
    0.06390599, 0.22963888, 0.00630981, -0.01897349, 0.67537268,
    0.08483369, -0.02534994, -0.02205197, -0.01667999, -0.00384443,
)

DEFAULT_KERN_8 = (
    -0.02928613, -0.03706353, -0.03783812, -0.03324558, -0.00447632,
    -0.02519406, -0.03752601, -0.03901508, -0.03663285, -0.00646649,
    -0.02066407, -0.03838633, -0.04002101, -0.03900035, -0.00901973,
    -0.01626393, -0.03954148, -0.04046620, -0.03979621, -0.01224485,
    0.29895328, 0.35757708, -0.02447552, -0.01081748, -0.04314594,
    0.23903219, 0.41119301, -0.00573046, -0.01450239, -0.04246845,
    0.17567618, 0.45220643, 0.02287757, -0.01936783, -0.03583255,
    0.11572472, 0.47416733, 0.06284440, -0.02685066, 0.42720050,
    -0.02248939, -0.01155273, -0.04562755, 0.28689496, 0.49093869,
    -0.00007891, -0.01545926, -0.04562659, 0.21238920, 0.53980934,
    0.03369474, -0.02070211, -0.03866988, 0.14229550, 0.56593398,
    0.08045181, -0.02888298, -0.03680918, -0.00542229, -0.02920477,
    -0.02788574, -0.02118180, -0.03942402, -0.00775547, -0.02433614,
    -0.03193943, -0.02030828, -0.04044014, -0.01074016, -0.01930822,
    -0.03620399, -0.01974125, -0.03919545, -0.01456093, -0.00045072,
    -0.00360110, -0.01020207, -0.01231907, -0.00638988, -0.00071592,
    -0.00279122, -0.00957115, -0.01288327, -0.00730937, -0.00107783,
    -0.00210156, -0.00890705, -0.01317668, -0.00813895, -0.00153491,
    -0.02128481, -0.04173044, -0.04831487, -0.03293190, -0.00525260,
    -0.01720322, -0.04052736, -0.05045706, -0.03607317, -0.00738030,
    -0.01341764, -0.03965629, -0.05151616, -0.03814886, -0.01005819,
    0.18968273, 0.33063684, -0.01300105, -0.01372950, -0.04017465,
    0.13727832, 0.36402234, 0.01027890, -0.01832107, -0.03365072,
    0.08734506, 0.38194295, 0.04338228, -0.02525993, 0.56408126,
    0.00458352, -0.01648227, -0.04887868, 0.24585519, 0.62026135,
    0.04314807, -0.02213737, -0.04158014, 0.16637289, 0.65027023,
    0.09621636, -0.03101388, -0.04082742, -0.00904519, -0.02790922,
    -0.02117818, 0.00798662, -0.03995711, -0.01243427, -0.02231705,
    -0.02946266, 0.00992055, -0.03600283, -0.01684920, -0.00111684,
    -0.00411204, -0.01297130, -0.01723725, -0.01022545, -0.00165306,
    -0.00313110, -0.01218016, -0.01763266, -0.01125620, -0.00231663,
    -0.01374149, -0.03797620, -0.05142937, -0.03117307, -0.00581914,
    -0.01064003, -0.03608089, -0.05272168, -0.03375670, -0.00795586,
    0.09628104, 0.27129991, -0.00353779, -0.01734151, -0.03153981,
    0.05686230, 0.28500998, 0.02230594, -0.02374955, 0.68214326,
    0.05018048, -0.02320852, -0.04383616, 0.18459474, 0.71517975,
    0.10805613, -0.03263677, -0.03637639, -0.01394373, -0.02511203,
    -0.01728636, 0.05407331, -0.02867568, -0.01893131, -0.00240854,
    -0.00446511, -0.01636187, -0.02377053, -0.01522848, -0.00333334,
    -0.00819975, -0.02964169, -0.04499287, -0.02745350, -0.00612408,
    0.02727416, 0.19446600, 0.00159832, -0.02232473, 0.74982506,
    0.11452620, -0.03348048, -0.01605681, -0.02070339, -0.00458223,
)


@bundle
class OpsinInverseMatrix:
    all_default: bool = field(Bool())
    inverse_matrix = field(Array(9, F16()), default=lambda s, ns: list(OPSIN_INVERSE_MATRIX_DEFAULT))
    opsin_biases = field(Array(3, F16()), default=lambda s, ns: list(OPSIN_BIASES_DEFAULT))
    quant_biases = field(Array(4, F16()), default=lambda s, ns: list(QUANT_BIASES_DEFAULT))


def _default_opsin_inverse_matrix():
    m = OpsinInverseMatrix.__new__(OpsinInverseMatrix)
    m.all_default = True
    m.inverse_matrix = list(OPSIN_INVERSE_MATRIX_DEFAULT)
    m.opsin_biases = list(OPSIN_BIASES_DEFAULT)
    m.quant_biases = list(QUANT_BIASES_DEFAULT)
    return m


@bundle
class CustomTransformData:
    # nonserialized ns = xyb_encoded: bool
    all_default: bool = field(Bool())
    opsin_inverse_matrix = field(
        OpsinInverseMatrix,
        condition=lambda s, ns: ns,
        default=lambda s, ns: _default_opsin_inverse_matrix(),
    )
    custom_weight_mask: int = field(Bits(3), default=0)
    weights2 = field(
        Array(15, F16()),
        condition=lambda s, ns: (s.custom_weight_mask & 1) != 0,
        default=lambda s, ns: list(DEFAULT_KERN_2),
    )
    weights4 = field(
        Array(55, F16()),
        condition=lambda s, ns: (s.custom_weight_mask & 2) != 0,
        default=lambda s, ns: list(DEFAULT_KERN_4),
    )
    weights8 = field(
        Array(210, F16()),
        condition=lambda s, ns: (s.custom_weight_mask & 4) != 0,
        default=lambda s, ns: list(DEFAULT_KERN_8),
    )


# -- file header ----------------------------------------------------------------


class FileHeader:
    """signature + Size + ImageMetadata + CustomTransformData."""

    def __init__(self, size: Size, image_metadata: ImageMetadata, transform_data: CustomTransformData):
        self.size = size
        self.image_metadata = image_metadata
        self.transform_data = transform_data

    @staticmethod
    def read(br: BitReader) -> "FileHeader":
        sig1 = br.read(8)
        sig2 = br.read(8)
        if (sig1, sig2) != (0xFF, 0x0A):
            raise InvalidSignature(f"bad codestream signature {sig1:02x}{sig2:02x}")
        size = Size.read_bundle(br)
        meta = ImageMetadata.read_bundle(br)
        tdata = CustomTransformData.read_bundle(br, meta.xyb_encoded)
        return FileHeader(size, meta, tdata)

    @property
    def xsize(self) -> int:
        return self.size.xsize

    @property
    def ysize(self) -> int:
        return self.size.ysize
