"""Error taxonomy for the decoder.

Mirrors the capability of the reference's typed error enum
(ref: jxl/src/error.rs) — in particular the `OutOfBounds(n)` convention:
every parsing routine that runs out of input raises OutOfBounds with the
number of *additional bytes* needed, which the streaming API layer turns
into `NeedsMoreInput{size_hint}` so decoding can resume byte-by-byte.
"""

from __future__ import annotations


class JxlError(Exception):
    """Base class for all decoder errors (malformed input, limits, ...)."""


class OutOfBounds(JxlError):
    """Ran out of input; `needed` more bytes are required to make progress.

    This is the universal resumability signal — see api/decoder.py.
    """

    def __init__(self, needed: int = 1):
        super().__init__(f"out of bounds: need {needed} more bytes")
        self.needed = max(int(needed), 1)


class InvalidBitstream(JxlError):
    """Malformed codestream (bad signature, invalid field, range error...)."""


class NonZeroPadding(InvalidBitstream):
    pass


class InvalidEnum(InvalidBitstream):
    def __init__(self, enum_name: str, value: int):
        super().__init__(f"invalid value {value} for enum {enum_name}")


class InvalidSignature(InvalidBitstream):
    pass


class SizeOverflow(InvalidBitstream):
    pass


class ArithmeticOverflow(InvalidBitstream):
    pass


class LimitExceeded(JxlError):
    """Decoder-configured resource limit exceeded (e.g. sample_limit)."""


class NotSupported(JxlError):
    """Valid bitstream uses a feature this build does not implement yet."""


class InternalError(JxlError):
    """Invariant violation — a bug in the decoder, not the input."""


# -- typed variants ---------------------------------------------------------
#
# Mirrors the reference's error enum families (jxl/src/error.rs:19): each
# class is a typed, catchable variant; fuzz tiers and conformance assert
# these specific types for known-bad corpora.

# entropy coding
class InvalidAnsHistogram(InvalidBitstream): pass
class AnsChecksumMismatch(InvalidBitstream): pass
class AlphabetTooLarge(InvalidBitstream): pass
class InvalidHuffman(InvalidBitstream): pass
class InvalidContextMap(InvalidBitstream): pass
class InvalidUintConfig(InvalidBitstream): pass
class Lz77Disallowed(InvalidBitstream): pass
class InvalidHistogramIndex(InvalidBitstream): pass

# modular: MA tree
class TreeTooLarge(InvalidBitstream): pass
class TreeTooTall(InvalidBitstream): pass
class TreeSplitOnEmptyRange(InvalidBitstream): pass
class TreeMultiplierTooLarge(InvalidBitstream): pass
class InvalidPredictor(InvalidBitstream): pass
class InvalidProperty(InvalidBitstream): pass
class NoGlobalTree(InvalidBitstream): pass

# modular: transforms
class InvalidRCT(InvalidBitstream): pass
class TooManySqueezes(InvalidBitstream): pass
class MetaSqueezeRequiresInPlace(InvalidBitstream): pass
class InvalidChannelRange(InvalidBitstream): pass
class MixingDifferentChannels(InvalidBitstream): pass
class DimShiftTooLarge(InvalidBitstream): pass

# VarDCT
class InvalidVarDCTTransform(InvalidBitstream): pass
class InvalidVarDCTTransformMap(InvalidBitstream): pass
class HFBlockOutOfBounds(InvalidBitstream): pass
class InvalidBlockSizeForChromaSubsampling(InvalidBitstream): pass
class InvalidQuantEncoding(InvalidBitstream): pass
class InvalidQuantizationTableWeight(InvalidBitstream): pass
class InvalidDistanceBand(InvalidBitstream): pass
class InvalidAFVBands(InvalidBitstream): pass
class InvalidRawQuantTable(InvalidBitstream): pass
class HfQuantFactorTooSmall(InvalidBitstream): pass
class LfQuantFactorTooSmall(InvalidBitstream): pass
class InvalidEpfValue(InvalidBitstream): pass
class InvalidNumNonZeros(InvalidBitstream): pass
class EndOfBlockResidualNonZeros(InvalidBitstream): pass
class TooManyBlockContexts(InvalidBitstream): pass
class BaseColorCorrelationOutOfRange(InvalidBitstream): pass
class Non444ChromaSubsampling(InvalidBitstream): pass

# permutations / TOC
class InvalidPermutation(InvalidBitstream): pass

# headers
class ImageDimensionTooLarge(InvalidBitstream): pass
class InvalidBitsPerSample(InvalidBitstream): pass
class InvalidExponent(InvalidBitstream): pass
class InvalidMantissa(InvalidBitstream): pass
class InvalidGamma(InvalidBitstream): pass
class InvalidIntensityTarget(InvalidBitstream): pass
class InvalidMinNits(InvalidBitstream): pass
class InvalidLinearBelow(InvalidBitstream): pass
class InvalidColorEncoding(InvalidBitstream): pass
class InvalidLfLevel(InvalidBitstream): pass
class InvalidEcUpsampling(InvalidBitstream): pass
class TooManyExtraChannels(InvalidBitstream): pass
class InvalidPasses(InvalidBitstream): pass
class FloatNaNOrInf(InvalidBitstream): pass
class InvalidBlending(InvalidBitstream): pass
class NoLfFrame(InvalidBitstream): pass

# features: patches
class PatchesInvalidBlendMode(InvalidBitstream): pass
class PatchesInvalidAlphaChannel(InvalidBitstream): pass
class PatchesInvalidReference(InvalidBitstream): pass
class PatchesInvalidPosition(InvalidBitstream): pass
class PatchesOutOfBounds(InvalidBitstream): pass
class PatchesTooMany(InvalidBitstream): pass
class PatchesPostColorTransform(InvalidBitstream): pass
class PatchesInvalidDelta(InvalidBitstream): pass
class PatchesUnsupportedMixedUpsampling(InvalidBitstream): pass

# features: splines
class SplinesTooMany(InvalidBitstream): pass
class SplinesTooManyControlPoints(InvalidBitstream): pass
class SplinesAreaTooLarge(InvalidBitstream): pass
class SplinesPointOutOfRange(InvalidBitstream): pass
class SplinesDeltaLimit(InvalidBitstream): pass
class SplinesDistanceTooLarge(InvalidBitstream): pass
class SplineAdjacentCoincidingControlPoints(InvalidBitstream): pass

# container / boxes / ICC
class InvalidBox(InvalidBitstream): pass
class InvalidIccStream(InvalidBitstream): pass
class IccEndOfStream(InvalidBitstream): pass
class IccTooLarge(InvalidBitstream): pass

# frames / references
class NonPatchReferenceWithCrop(InvalidBitstream): pass
class SectionTooShort(InvalidBitstream): pass

# native decode failures surface as typed bitstream errors
class NativeDecodeError(InvalidBitstream): pass


class NativeBuildError(JxlError):
    """A native library (g++ host decoder or nvcc kernel) failed to build."""
