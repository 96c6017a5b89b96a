"""Colour management: lcms2 through ctypes, for ICC transforms on the host.

Counterpart of jxl_tpu/color/cms.py (capability reference:
jxl_cms/src/lib.rs, the JxlCms / JxlCmsTransformer traits over lcms2): N
independent transformers over interleaved float32 rows, and the sRGB
profile, both from the system's liblcms2 (or the copy a Pillow wheel
carries). Where no liblcms2 can be loaded, every entry point raises
CmsUnavailable; nothing passes pixels through untransformed. Only the
CLI's --to_srgb reaches this module.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

# lcms2 pixel format codes: FLOAT_SH(1) | COLORSPACE_SH(PT_*) | CHANNELS_SH(n) | BYTES_SH(4)
TYPE_RGB_FLT = (1 << 22) | (4 << 16) | (3 << 3) | 4
TYPE_GRAY_FLT = (1 << 22) | (3 << 16) | (1 << 3) | 4

INTENT_PERCEPTUAL = 0
INTENT_RELATIVE_COLORIMETRIC = 1
INTENT_SATURATION = 2
INTENT_ABSOLUTE_COLORIMETRIC = 3

_lib = None


class CmsUnavailable(RuntimeError):
    """No liblcms2 could be loaded."""


def _candidates() -> list:
    """Library names to try: the system's, then a Pillow wheel's bundled
    copy (site-packages/pillow.libs), found without importing Pillow."""
    import glob
    import importlib.util
    import os

    names = [ctypes.util.find_library("lcms2")]
    spec = importlib.util.find_spec("PIL")
    if spec is not None and spec.origin:
        libs = os.path.join(os.path.dirname(os.path.dirname(spec.origin)), "pillow.libs")
        names += sorted(glob.glob(os.path.join(libs, "liblcms2*")))
    return [n for n in names if n]


def _lcms():
    global _lib
    if _lib is None:
        for name in _candidates():
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                continue
        else:
            raise CmsUnavailable(
                "liblcms2 not found: colour management (--to_srgb) needs the lcms2 library")
        lib.cmsOpenProfileFromMem.restype = ctypes.c_void_p
        lib.cmsOpenProfileFromMem.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.cmsCreateTransform.restype = ctypes.c_void_p
        lib.cmsCreateTransform.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.cmsDoTransform.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32
        ]
        lib.cmsCloseProfile.argtypes = [ctypes.c_void_p]
        lib.cmsDeleteTransform.argtypes = [ctypes.c_void_p]
        lib.cmsGetColorSpace.restype = ctypes.c_uint32
        lib.cmsGetColorSpace.argtypes = [ctypes.c_void_p]
        lib.cmsCreate_sRGBProfile.restype = ctypes.c_void_p
        lib.cmsCreate_sRGBProfile.argtypes = []
        lib.cmsSaveProfileToMem.restype = ctypes.c_int
        lib.cmsSaveProfileToMem.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)
        ]
        _lib = lib
    return _lib


def _fmt_for(profile_handle) -> tuple[int, int]:
    """(lcms pixel format, channel count) of a profile's colour space."""
    sig = _lcms().cmsGetColorSpace(profile_handle)  # an ICC colour space signature
    if sig == 0x47524159:  # 'GRAY'
        return TYPE_GRAY_FLT, 1
    return TYPE_RGB_FLT, 3


class CmsTransformer:
    """One ICC transform over interleaved float32 pixels (ref
    JxlCmsTransformer: run(&mut [f32]))."""

    def __init__(self, src_icc: bytes, dst_icc: bytes, intent: int = INTENT_RELATIVE_COLORIMETRIC):
        lib = _lcms()
        self._src = lib.cmsOpenProfileFromMem(src_icc, len(src_icc))
        self._dst = lib.cmsOpenProfileFromMem(dst_icc, len(dst_icc))
        if not self._src or not self._dst:
            raise ValueError("invalid ICC profile")
        in_fmt, self.in_channels = _fmt_for(self._src)
        out_fmt, self.out_channels = _fmt_for(self._dst)
        self._xform = lib.cmsCreateTransform(self._src, in_fmt, self._dst, out_fmt, intent, 0)
        if not self._xform:
            raise ValueError("could not create ICC transform")

    def run(self, pixels: np.ndarray) -> np.ndarray:
        """pixels: (..., in_channels) float32, interleaved; returns the
        transformed (..., out_channels) float32 array."""
        lib = _lcms()
        flat = np.ascontiguousarray(pixels, dtype=np.float32)
        n = flat.size // self.in_channels
        out = np.empty(flat.shape[:-1] + (self.out_channels,), dtype=np.float32)
        lib.cmsDoTransform(self._xform, flat.ctypes.data_as(ctypes.c_void_p),
                           out.ctypes.data_as(ctypes.c_void_p), n)
        return out

    def __del__(self):  # pragma: no cover
        lib = _lib
        if lib is None:
            return
        if getattr(self, "_xform", None):
            lib.cmsDeleteTransform(self._xform)
        for h in (getattr(self, "_src", None), getattr(self, "_dst", None)):
            if h:
                lib.cmsCloseProfile(h)


class JxlCms:
    """CMS interface (ref jxl_cms/src/lib.rs:28-50): N parallel
    transformers for a source and destination profile pair."""

    @staticmethod
    def begin_transforms(
        src_icc: bytes, dst_icc: bytes, num: int = 1, intent: int = INTENT_RELATIVE_COLORIMETRIC
    ) -> list[CmsTransformer]:
        return [CmsTransformer(src_icc, dst_icc, intent) for _ in range(num)]


def srgb_profile() -> bytes:
    """lcms2's built-in sRGB profile, serialised (the profile Pillow's
    ImageCms.createProfile("sRGB") makes, through the same call)."""
    lib = _lcms()
    h = lib.cmsCreate_sRGBProfile()
    if not h:
        raise CmsUnavailable("lcms2 could not create the sRGB profile")
    try:
        size = ctypes.c_uint32(0)
        if not lib.cmsSaveProfileToMem(h, None, ctypes.byref(size)):
            raise ValueError("lcms2 could not size the sRGB profile")
        buf = ctypes.create_string_buffer(size.value)
        if not lib.cmsSaveProfileToMem(h, buf, ctypes.byref(size)):
            raise ValueError("lcms2 could not write the sRGB profile")
        return buf.raw[: size.value]
    finally:
        lib.cmsCloseProfile(h)
